"""Submodular objectives as fixed-shape state machines (the port of
``src/repro/core/objectives.py``: ``FacilityLocation``,
``FacilityLocationPre``, ``SaturatedCoverage``, ``InformationGain``,
``LogDetDPP``, ``GraphCut``, ``Modular``, the warm-start bound maintainers
and ``set_value``).

The interface is the reference's:

    state = obj.init(eval_feats, eval_mask)      # f restricted to the eval set
    gains = obj.gains(state, cand_feats)         # f(S+v) - f(S), every v
    best, idx = obj.select(state, cand_feats, feasible)   # fused top-1 step
    state = obj.update(state, chosen_feat)       # S <- S + {v*}
    value = obj.value(state)                     # f(S)

A ``jax.vmap`` over GreeDi's partitions becomes a leading partition axis
written out: every state field may carry one (P, ...) axis, and the
evaluation features/mask either carry it too or are shared by every
partition.  Gains and select route through kernels/dispatch.py by the
``backend`` field ("cuda" | "ref" | "auto").

Similarities outside ``dispatch.FUSED_SIMS`` (``neg_sq_dist``, the k-means
dissimilarity of Sec. 6.1) take the generic path, as in the reference: the
similarity block is a ``torch.matmul`` (cuBLAS on the card) cut into
candidate chunks of at most ``_GENERIC_BLOCK_BYTES``, facility location's
masked relu-reduce over it is the ``relu_colsum`` kernel (a dead eval row
gets cov = +inf, which relu zeroes; the eval masks are 0/1 at every
caller), and the other objectives apply their reference formulas to the
block.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.kernels import dispatch, ring
# The masked-gain floor and the lowest-index masked argmax are defined ONCE,
# in kernels/ref.py, and re-exported as the core layer's select path.
from repro_torch.kernels.ref import NEG, masked_top1  # noqa: F401


def _kernel_h(kernel_kwargs: tuple) -> float:
  """Bandwidth for the fused oracles (ignored by the linear kernel)."""
  return float(dict(kernel_kwargs).get("h", 0.75))


# ---------------------------------------------------------------------------
# Similarity kernels (the reference's formulas, with optional leading axes)
# ---------------------------------------------------------------------------


def _sq_norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
  """sum(x * x) over the last axis: each row's squared norm over its
  features (or over a Cholesky column's k entries)."""
  # repro: allow(T8): one output per row, never a shard's row sum: the bits do not depend on how many shards one tensor holds (test_cuda_row_norms_layout_independent)
  return torch.sum(x * x, dim=-1, keepdim=keepdim)


def linear_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  """Dot-product similarity: (..., n, d) x (..., m, d) -> (..., n, m)."""
  return x @ y.transpose(-1, -2)


def rbf_kernel(x: torch.Tensor, y: torch.Tensor,
               h: float = 0.75) -> torch.Tensor:
  """Squared-exponential kernel exp(-|x - y|^2 / h^2) (paper Sec. 3.4.1)."""
  x2 = _sq_norm(x, keepdim=True)
  y2 = _sq_norm(y, keepdim=True)
  d2 = torch.clamp_min(x2 - 2.0 * (x @ y.transpose(-1, -2))
                       + y2.transpose(-1, -2), 0.0)
  return torch.exp(-d2 / (h * h))


def neg_sq_dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  """-|x - y|^2, the negated k-means dissimilarity l = d^2 of Sec. 6.1
  (no clamp): (..., n, d) x (..., m, d) -> (..., n, m)."""
  x2 = _sq_norm(x, keepdim=True)
  y2 = _sq_norm(y, keepdim=True)
  return -(x2 - 2.0 * (x @ y.transpose(-1, -2)) + y2.transpose(-1, -2))


KERNELS = {"linear": linear_kernel, "rbf": rbf_kernel,
           "neg_sq_dist": neg_sq_dist}


def _check_sim(owner: str, kernel: str) -> None:
  if kernel not in KERNELS:
    raise ValueError(f"{owner} kernel {kernel!r} not in {sorted(KERNELS)}")


def _row_sum(x: torch.Tensor) -> torch.Tensor:
  """Sum over the last axis: ``torch.sum`` on the CPU; on CUDA by halving
  (the row zero-padded to a power of two, then its two halves added until
  one entry is left), an order that depends on the row's length alone.
  ``torch.sum`` on CUDA splits a row among threads by the whole tensor's
  shape (fewer than 16 rows take wider blocks), so a partition's sum would
  part in its last bits between the m / world partitions a rank of a
  process mesh holds and the stacked batch of m."""
  if not x.is_cuda:
    return torch.sum(x, dim=-1)
  n = x.shape[-1]
  width = 1 << max(n - 1, 0).bit_length()
  if width != n:
    x = torch.nn.functional.pad(x, (0, width - n))
  while x.shape[-1] > 1:
    half = x.shape[-1] // 2
    x = x[..., :half] + x[..., half:]
  return x[..., 0]


def _sim_column(eval_feats: torch.Tensor, feat: torch.Tensor, kernel: str,
                h: float) -> torch.Tensor:
  """sim(e_i, feat) for every eval row: eval_feats ((P,) ne, d) against
  feat ((P,) d) -> ((P,) ne).  The formulas of ``KERNELS``."""
  if eval_feats.dim() == 2 and feat.dim() == 2:  # shared eval set
    dot = feat @ eval_feats.T
  else:
    dot = (eval_feats @ feat.unsqueeze(-1)).squeeze(-1)
  if kernel == "linear":
    return dot
  x2 = _sq_norm(eval_feats)
  y2 = _sq_norm(feat, keepdim=True)
  if kernel == "neg_sq_dist":
    return -(x2 - 2.0 * dot + y2)
  d2 = torch.clamp_min(x2 - 2.0 * dot + y2, 0.0)
  return torch.exp(-d2 / (h * h))


# ---------------------------------------------------------------------------
# The generic path (similarities outside dispatch.FUSED_SIMS)
# ---------------------------------------------------------------------------

# bytes of one similarity block of the generic path: the candidates go
# that many columns at a time (the stacked round 1 at n = 262144, m = 16
# would otherwise hold 16 x 16384^2 floats, 16 GiB, a step)
_GENERIC_BLOCK_BYTES = 1 << 30


def _sim_block(x: torch.Tensor, y: torch.Tensor, kernel: str,
               h: float) -> torch.Tensor:
  """sim(x_i, y_j) float32, ((P,) n, m), in the bits of ``KERNELS``'
  formulas but in place on the one product buffer (negation and scaling
  by 2 are exact, so x2 - 2 x.y is x2 + (-2 x.y) and -(a + b) is -a - b
  in IEEE arithmetic), so a block costs one buffer, not four."""
  x, y = x.float(), y.float()
  s = x @ y.transpose(-1, -2)
  if kernel == "linear":
    return s
  x2 = _sq_norm(x, keepdim=True)
  y2 = _sq_norm(y, keepdim=True).transpose(-1, -2)
  if kernel == "neg_sq_dist":
    # -((x2 - 2 s) + y2) is (2 s - x2) - y2 exactly: three passes, not four
    return s.mul_(2.0).sub_(x2).sub_(y2)
  s.mul_(-2.0).add_(x2).add_(y2)   # x2 and y2 broadcast into s
  return s.clamp_min_(0.0).neg_().div_(h * h).exp_()


def _lead(*shaped) -> tuple:
  """The partition axis of a call: () or (P,), from ((P,) n, ...) operands
  given as (tensor, core dims) pairs."""
  lead = torch.broadcast_shapes(*(t.shape[:t.dim() - c] for t, c in shaped))
  if len(lead) > 1:
    raise ValueError(f"at most one leading partition axis, got {lead}")
  return tuple(lead)


def _chunk_cols(p: int, ne: int) -> int:
  """Candidate columns a generic block holds under the byte budget."""
  return max(1, _GENERIC_BLOCK_BYTES // (4 * max(p, 1) * max(ne, 1)))


def _masked_colsum(s: torch.Tensor, cov: torch.Tensor,
                   eval_mask: torch.Tensor, colsum) -> torch.Tensor:
  """sum_i mask_i relu(s_ij - cov_i) over a ((P,) ne, nc) block, ((P,) nc)
  float32, as one ``colsum`` (``relu_colsum``) call.  The mask is 0/1: a
  dead row's cov becomes +inf, which relu zeroes."""
  lead = _lead((s, 2), (cov, 1), (eval_mask, 1))
  ne, nc = s.shape[-2:]
  p = lead[0] if lead else 1
  c = torch.where(eval_mask > 0, cov.float(), torch.inf).expand(p, ne)
  g = colsum(s.expand(p, ne, nc), c)
  return g if lead else g[0]


def _generic_facility(eval_feats, cand_feats, cov, eval_mask, kernel, h,
                      colsum) -> torch.Tensor:
  """sum_i mask_i relu(sim(e_i, c_j) - cov_i) for every candidate, ((P,)
  nc) float32: candidate chunks of ``_chunk_cols`` columns, each a
  ``_sim_block`` and one ``_masked_colsum``."""
  lead = _lead((eval_feats, 2), (cand_feats, 2), (cov, 1), (eval_mask, 1))
  ne, nc = eval_feats.shape[-2], cand_feats.shape[-2]
  step = _chunk_cols(lead[0] if lead else 1, ne)
  out = [_masked_colsum(_sim_block(eval_feats, cand_feats[..., c0:c0 + step,
                                                          :], kernel, h),
                        cov, eval_mask, colsum)
         for c0 in range(0, nc, step)]
  return torch.cat(out, dim=-1) if out else torch.zeros(
      (*lead, 0), dtype=torch.float32, device=eval_feats.device)


def _generic_coverage(eval_feats, cand_feats, cover, cap, eval_mask, kernel,
                      h) -> torch.Tensor:
  """The reference's generic saturated-coverage sum, mask @ (min(cover +
  relu(sim), cap) - min(cover, cap)), ((P,) nc) float32, in candidate
  chunks under the byte budget."""
  lead = _lead((eval_feats, 2), (cand_feats, 2), (cover, 1), (cap, 1),
               (eval_mask, 1))
  ne, nc = eval_feats.shape[-2], cand_feats.shape[-2]
  cover = cover.float().unsqueeze(-1)
  cap = cap.float().unsqueeze(-1)
  base = torch.minimum(cover, cap)
  w = eval_mask.float().unsqueeze(-2)
  step = _chunk_cols(lead[0] if lead else 1, ne)
  out = []
  for c0 in range(0, nc, step):
    s = _sim_block(eval_feats, cand_feats[..., c0:c0 + step, :], kernel,
                   h).clamp_min_(0.0)
    s = cover + s          # the full leading shape, a buffer of its own
    torch.minimum(s, cap, out=s)
    out.append((w @ s.sub_(base)).squeeze(-2))
  return torch.cat(out, dim=-1) if out else torch.zeros(
      (*lead, 0), dtype=torch.float32, device=eval_feats.device)


class FLState(NamedTuple):
  """cov[i] = max_{s in S} sim(i, s), clipped below at the phantom baseline."""
  cov: torch.Tensor          # ((P,) n_eval) current best similarity
  eval_feats: torch.Tensor   # ((P,) n_eval, d), shared when 2-D
  eval_mask: torch.Tensor    # ((P,) n_eval) 1.0 for live eval rows
  value: torch.Tensor        # ((P,)) f(S)


@dataclasses.dataclass(frozen=True)
class FacilityLocation:
  """f(S) = mean_i [ max_{s in S} sim(e_i, s) - baseline ]_+ over the live
  eval rows.  With ``sim = -l`` (``neg_sq_dist``) and ``baseline = -l(e_i,
  e_0)`` this is the phantom-exemplar k-medoid surrogate of Eq. (6).
  Monotone, nonnegative, decomposable (Sec. 4.5 of the paper).

  A linear or rbf similarity (``kernel_kwargs=(("h", h),)``) runs through
  the fused facility kernels; any other in ``KERNELS`` takes the generic
  path (a cuBLAS block, then the ``relu_colsum`` kernel), where ``select``
  is ``masked_top1`` over the gains.
  """
  monotone = True  # marginal gains are >= 0 and diminishing (lazy-exact)

  kernel: str = "linear"
  kernel_kwargs: tuple = ()
  baseline: float = 0.0
  backend: str = "auto"

  def __post_init__(self):
    _check_sim("FacilityLocation", self.kernel)

  @property
  def h(self) -> float:
    return _kernel_h(self.kernel_kwargs)

  @property
  def fused(self) -> bool:
    return self.kernel in dispatch.FUSED_SIMS

  def init(self, eval_feats: torch.Tensor,
           eval_mask: torch.Tensor | None = None) -> FLState:
    if self.fused:
      eval_feats = ring.pitched(eval_feats)  # padded once, not once a call
    if eval_mask is None:
      eval_mask = torch.ones(eval_feats.shape[:-1], dtype=eval_feats.dtype,
                             device=eval_feats.device)
    cov = torch.full(eval_feats.shape[:-1], self.baseline,
                     dtype=eval_feats.dtype, device=eval_feats.device)
    value = torch.zeros(eval_feats.shape[:-2], dtype=eval_feats.dtype,
                        device=eval_feats.device)
    return FLState(cov, eval_feats, eval_mask, value)

  def kernel_rows(self, cand_feats: torch.Tensor) -> torch.Tensor:
    """The candidates as the kernels read them with no copy a call
    (``ring.pitched``); a greedy run takes them so once."""
    return ring.pitched(cand_feats) if self.fused else cand_feats

  def broadcast(self, state: FLState, n_part: int) -> FLState:
    """The same state for each of ``n_part`` partitions: cov and value get a
    leading axis, the evaluation set stays shared (stride 0 in the kernels).
    The counterpart of vmapping over a closed-over state."""
    return FLState(state.cov.expand(n_part, -1).clone(), state.eval_feats,
                   state.eval_mask, state.value.expand(n_part).clone())

  def _denom(self, state: FLState) -> torch.Tensor:
    # repro: allow(T8): a count of 0/1 mask entries, exact in float32 in any order
    return torch.clamp_min(torch.sum(state.eval_mask, dim=-1), 1.0)

  def _partial(self, state: FLState, cand_feats: torch.Tensor):
    if self.fused:
      fn = dispatch.resolve("facility_gain", self.backend)
      return fn(state.eval_feats, cand_feats, state.cov, state.eval_mask,
                kernel=self.kernel, h=self.h)
    return _generic_facility(state.eval_feats, cand_feats, state.cov,
                             state.eval_mask, self.kernel, self.h,
                             dispatch.resolve("relu_colsum", self.backend))

  def gains(self, state: FLState, cand_feats: torch.Tensor) -> torch.Tensor:
    return self._partial(state, cand_feats) / self._denom(state).unsqueeze(-1)

  def select(self, state: FLState, cand_feats: torch.Tensor,
             feasible: torch.Tensor):
    """Select step: (best normalized gain, int64 candidate index), one fused
    launch for a fused similarity."""
    if not self.fused:
      return masked_top1(self.gains(state, cand_feats), feasible)
    fn = dispatch.resolve_select("facility_gain", self.backend)
    best, idx = fn(state.eval_feats, cand_feats, state.cov, state.eval_mask,
                   feasible, kernel=self.kernel, h=self.h)
    return best / self._denom(state), idx

  def update(self, state: FLState, feat: torch.Tensor) -> FLState:
    sim = _sim_column(state.eval_feats, feat, self.kernel, self.h)
    new_cov = torch.maximum(state.cov, sim)
    gain = _row_sum((new_cov - state.cov) * state.eval_mask)
    return FLState(new_cov, state.eval_feats, state.eval_mask,
                   state.value + gain / self._denom(state))

  def value(self, state: FLState) -> torch.Tensor:
    return state.value

  def partial_stats(self, state: FLState, cand_feats: torch.Tensor):
    """(sum-of-gains ((P,) nc), live count ((P,))): summing both over shards
    reproduces the global objective exactly."""
    return (self._partial(state, cand_feats),
            # repro: allow(T8): a count of 0/1 mask entries, exact in float32 in any order
            torch.sum(state.eval_mask, dim=-1))


class FLPreState(NamedTuple):
  cov: torch.Tensor          # ((P,) n_eval) current best similarity
  sim: torch.Tensor          # ((P,) n_eval, n_cand) cached similarities
  eval_feats: torch.Tensor   # ((P,) n_eval, d), shared when 2-D
  eval_mask: torch.Tensor    # ((P,) n_eval) 1.0 for live eval rows
  value: torch.Tensor        # ((P,)) f(S)


@dataclasses.dataclass(frozen=True)
class FacilityLocationPre:
  """Facility location with the (eval x cand) similarity block cached once
  a greedy run instead of recomputed every step: a step is one
  ``relu_colsum`` launch over the cache (the masked relu-reduce; a dead
  eval row's cov is +inf).  The cache is O(n_e n_c) on the device, so
  this is the small-n path.

  ``init(eval_feats, eval_mask, cand_feats)`` builds the ((P,) ne, nc)
  block, through the ``pairwise`` kernel for a fused similarity (the
  fast engine's ``s11`` bits) and through ``_sim_block`` otherwise.
  ``update`` recomputes the chosen column from the features, as the
  reference does.  ``supports_lazy = False``: ``gains`` answers for the
  cached candidates whatever slice it is handed, so greedy's lazy mode
  falls back to standard.
  """
  monotone = True
  supports_lazy = False

  kernel: str = "linear"
  kernel_kwargs: tuple = ()
  baseline: float = 0.0
  backend: str = "auto"

  def __post_init__(self):
    _check_sim("FacilityLocationPre", self.kernel)

  @property
  def h(self) -> float:
    return _kernel_h(self.kernel_kwargs)

  def init(self, eval_feats: torch.Tensor,
           eval_mask: torch.Tensor | None = None,
           cand_feats: torch.Tensor | None = None) -> FLPreState:
    if eval_mask is None:
      eval_mask = torch.ones(eval_feats.shape[:-1], dtype=eval_feats.dtype,
                             device=eval_feats.device)
    if cand_feats is None:
      cand_feats = eval_feats
    if self.kernel in dispatch.FUSED_SIMS:
      sim = dispatch.resolve("pairwise", self.backend)(
          eval_feats, cand_feats, kernel=self.kernel, h=self.h)
    else:
      sim = _sim_block(eval_feats, cand_feats, self.kernel, self.h)
    cov = torch.full(eval_feats.shape[:-1], self.baseline,
                     dtype=eval_feats.dtype, device=eval_feats.device)
    value = torch.zeros(eval_feats.shape[:-2], dtype=eval_feats.dtype,
                        device=eval_feats.device)
    return FLPreState(cov, sim, eval_feats, eval_mask, value)

  def broadcast(self, state: FLPreState, n_part: int) -> FLPreState:
    """The same state for each of ``n_part`` partitions: cov and value get a
    leading axis; the cache and the evaluation set stay shared."""
    return FLPreState(state.cov.expand(n_part, -1).clone(), state.sim,
                      state.eval_feats, state.eval_mask,
                      state.value.expand(n_part).clone())

  def _denom(self, state: FLPreState) -> torch.Tensor:
    # repro: allow(T8): a count of 0/1 mask entries, exact in float32 in any order
    return torch.clamp_min(torch.sum(state.eval_mask, dim=-1), 1.0)

  def gains(self, state: FLPreState, cand_feats: torch.Tensor):
    del cand_feats  # the cached candidate set answers
    g = _masked_colsum(state.sim, state.cov, state.eval_mask,
                       dispatch.resolve("relu_colsum", self.backend))
    return g / self._denom(state).unsqueeze(-1)

  def select(self, state: FLPreState, cand_feats: torch.Tensor,
             feasible: torch.Tensor):
    return masked_top1(self.gains(state, cand_feats), feasible)

  def update(self, state: FLPreState, feat: torch.Tensor) -> FLPreState:
    sim = _sim_column(state.eval_feats, feat, self.kernel, self.h)
    new_cov = torch.maximum(state.cov, sim)
    # repro: allow(T8): FacilityLocationPre has no partial_stats, so no process-mesh engine runs it and no stacked-vs-ranks comparison reaches this sum
    gain = torch.sum((new_cov - state.cov) * state.eval_mask, dim=-1)
    return FLPreState(new_cov, state.sim, state.eval_feats, state.eval_mask,
                      state.value + gain / self._denom(state))

  def value(self, state: FLPreState) -> torch.Tensor:
    return state.value


# ---------------------------------------------------------------------------
# Saturated coverage (Lin & Bilmes 2011)
# ---------------------------------------------------------------------------

# Candidate rows per call of the ``total`` pass (C_i(V) of every eval row):
# a plain version on the card holds (P, ne, chunk) floats, not (P, ne, ne).
_TOTAL_CHUNK = 16384


class SatCovState(NamedTuple):
  cover: torch.Tensor       # ((P,) n_eval) accumulated similarity mass
  cap: torch.Tensor         # ((P,) n_eval) saturation alpha * C_i(V), fixed
  #                           at init; shared when 1-D under a batched cover
  eval_feats: torch.Tensor  # ((P,) n_eval, d), shared when 2-D
  eval_mask: torch.Tensor   # ((P,) n_eval) 1.0 for live eval rows
  value: torch.Tensor       # ((P,)) f(S)


@dataclasses.dataclass(frozen=True)
class SaturatedCoverage:
  """Lin & Bilmes' document-summarization objective,

      f(S) = mean_i min(C_i(S), alpha C_i(V)),  C_i(S) = sum_{j in S} s_ij,

  over the live eval rows, s = relu(sim).  Monotone submodular; the
  saturation rewards covering every document a little instead of a few a
  lot.  ``total`` (C_i(V)) may be passed to ``init`` (each machine may use
  its own partition's levels, Sec. 4.5); otherwise it is computed once from
  the eval set and carried in the state as ``cap``.  A linear or rbf
  similarity runs through the ``coverage_gain`` kernels and their fused
  top-1; any other in ``KERNELS`` takes the generic path (the reference's
  formula over cuBLAS blocks).  Unlike the reference, ``total`` is
  keyword-only, so ``init`` keeps the 2-argument meaning under greedi's
  arity hook (``_call_init``) instead of receiving the candidate block as
  its levels.
  """
  monotone = True

  kernel: str = "linear"
  kernel_kwargs: tuple = ()
  alpha: float = 0.25
  backend: str = "auto"

  def __post_init__(self):
    _check_sim("SaturatedCoverage", self.kernel)

  @property
  def h(self) -> float:
    return _kernel_h(self.kernel_kwargs)

  @property
  def fused(self) -> bool:
    return self.kernel in dispatch.FUSED_SIMS

  def total(self, eval_feats: torch.Tensor,
            eval_mask: torch.Tensor) -> torch.Tensor:
    """C_i(V) = sum_j mask_j relu(sim(e_i, e_j)) for every eval row, without
    the (ne, ne) similarity block: the coverage gain of each eval row taken
    as a candidate, from cover 0 under an infinite cap, is
    sum_j mask_j relu(sim(e_j, e_i)), which the symmetry of sim makes
    C_i(V).  Candidate rows go ``_TOTAL_CHUNK`` at a time.  The generic
    path sums relu(sim(e_i, e_j)) mask_j over row chunks as the reference
    does (its formula need not be symmetric in the bits)."""
    if not self.fused:
      ne = eval_feats.shape[-2]
      w = eval_mask.float().unsqueeze(-1)
      step = _chunk_cols(eval_feats.shape[0] if eval_feats.dim() == 3
                         else 1, ne)
      return torch.cat([
          (_sim_block(eval_feats[..., r0:r0 + step, :], eval_feats,
                      self.kernel, self.h).clamp_min_(0.0) @ w)[..., 0]
          for r0 in range(0, ne, step)], dim=-1)
    fn = dispatch.resolve("coverage_gain", self.backend)
    lead = eval_feats.shape[:-1]
    zero = torch.zeros(lead, dtype=torch.float32, device=eval_feats.device)
    inf = torch.full(lead, float("inf"), dtype=torch.float32,
                     device=eval_feats.device)
    ne = eval_feats.shape[-2]
    return torch.cat([
        fn(eval_feats, eval_feats[..., c0:c0 + _TOTAL_CHUNK, :].contiguous(),
           zero, inf, eval_mask, kernel=self.kernel, h=self.h)
        for c0 in range(0, ne, _TOTAL_CHUNK)], dim=-1)

  def init(self, eval_feats: torch.Tensor,
           eval_mask: torch.Tensor | None = None, *,
           total: torch.Tensor | None = None) -> SatCovState:
    if self.fused:
      eval_feats = ring.pitched(eval_feats)  # padded once, not once a call
    lead = eval_feats.shape[:-1]
    dev = eval_feats.device
    if eval_mask is None:
      eval_mask = torch.ones(lead, dtype=eval_feats.dtype, device=dev)
    if total is None:
      total = self.total(eval_feats, eval_mask)
    cover = torch.zeros(lead, dtype=torch.float32, device=dev)
    value = torch.zeros(lead[:-1], dtype=torch.float32, device=dev)
    return SatCovState(cover, self.alpha * total.float(), eval_feats,
                       eval_mask, value)

  def kernel_rows(self, cand_feats: torch.Tensor) -> torch.Tensor:
    """The candidates as the kernels read them with no copy a call
    (``ring.pitched``); a greedy run takes them so once."""
    return ring.pitched(cand_feats) if self.fused else cand_feats

  def broadcast(self, state: SatCovState, n_part: int) -> SatCovState:
    """The same state for each of ``n_part`` partitions: cover and value get
    a leading axis, the evaluation set and the cap stay shared (stride 0
    in the kernels)."""
    return SatCovState(state.cover.expand(n_part, -1).clone(), state.cap,
                       state.eval_feats, state.eval_mask,
                       state.value.expand(n_part).clone())

  def _denom(self, state: SatCovState) -> torch.Tensor:
    # repro: allow(T8): a count of 0/1 mask entries, exact in float32 in any order
    return torch.clamp_min(torch.sum(state.eval_mask.float(), dim=-1), 1.0)

  def _partial(self, state: SatCovState, cand_feats: torch.Tensor):
    if not self.fused:
      return _generic_coverage(state.eval_feats, cand_feats, state.cover,
                               state.cap, state.eval_mask, self.kernel,
                               self.h)
    fn = dispatch.resolve("coverage_gain", self.backend)
    return fn(state.eval_feats, cand_feats, state.cover, state.cap,
              state.eval_mask, kernel=self.kernel, h=self.h)

  def gains(self, state: SatCovState, cand_feats: torch.Tensor):
    return self._partial(state, cand_feats) / self._denom(state).unsqueeze(-1)

  def select(self, state: SatCovState, cand_feats: torch.Tensor,
             feasible: torch.Tensor):
    """Select step: (best normalized gain, int64 candidate index), one fused
    launch for a fused similarity."""
    if not self.fused:
      return masked_top1(self.gains(state, cand_feats), feasible)
    fn = dispatch.resolve_select("coverage_gain", self.backend)
    best, idx = fn(state.eval_feats, cand_feats, state.cover, state.cap,
                   state.eval_mask, feasible, kernel=self.kernel, h=self.h)
    return best / self._denom(state), idx

  def update(self, state: SatCovState, feat: torch.Tensor) -> SatCovState:
    sim = torch.clamp_min(_sim_column(state.eval_feats, feat, self.kernel,
                                      self.h), 0.0)
    new_cover = state.cover + sim
    inc = (torch.minimum(new_cover, state.cap)
           - torch.minimum(state.cover, state.cap))
    gain = _row_sum(inc * state.eval_mask) / self._denom(state)
    return SatCovState(new_cover, state.cap, state.eval_feats,
                       state.eval_mask, state.value + gain)

  def value(self, state: SatCovState) -> torch.Tensor:
    return state.value

  def partial_stats(self, state: SatCovState, cand_feats: torch.Tensor):
    """(sum-of-gains ((P,) nc), live count ((P,))): summing both over shards
    reproduces the global objective (the round-2 engine's contract)."""
    return (self._partial(state, cand_feats),
            # repro: allow(T8): a count of 0/1 mask entries, exact in float32 in any order
            torch.sum(state.eval_mask.float(), dim=-1))


# ---------------------------------------------------------------------------
# Information gain for GP active-set selection (Sec. 3.4.1) and the DPP
# log-det, on one incremental Cholesky
# ---------------------------------------------------------------------------


class IGState(NamedTuple):
  sel_feats: torch.Tensor  # ((P,) k_max, d) selected features, zero-padded
  count: torch.Tensor      # ((P,)) int64 number selected
  chol: torch.Tensor       # ((P,) k_max, k_max) Cholesky of K_SS + ridge I,
  #                          identity-padded
  value: torch.Tensor      # ((P,)) f(S)


class IGShardState(NamedTuple):
  """``IGState`` plus the shard's live evaluation-row count.

  Information gain is evaluation-set independent, so the sharded protocol
  needs nothing from the local partition but its live mass: weighting the
  (identical-on-every-shard) gains by it makes the engine's weighted mean
  reproduce them exactly (core/greedi.py ``_objective_engine``)."""
  inner: IGState
  n_live: torch.Tensor     # ((P,)) float32 live evaluation rows


def _masked_linv(chol: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
  """inv(L) with the columns of not-yet-selected rows zeroed, batched over
  any leading axes: linv @ k(S, cand) then equals L^-1 applied to the
  live-row-masked cross kernel, which the info-gain kernels consume (the
  identity padding of ``chol`` keeps the inverse defined for any count)."""
  k_max = chol.shape[-1]
  eye = torch.eye(k_max, dtype=chol.dtype, device=chol.device)
  linv = torch.linalg.solve_triangular(chol, eye.expand_as(chol),
                                       upper=False)
  live = torch.arange(k_max, device=chol.device) < count.unsqueeze(-1)
  return torch.where(live.unsqueeze(-2), linv, 0.0)


class _IncrementalCholesky:
  """The oracle both objectives share: an incremental Cholesky of
  M = K_SS + ridge I in a fixed (k_max, k_max) buffer and the conditional
  variance cond(v) = k(v, v) + ridge - |L^-1 k(S, v)|^2 of every candidate
  through the ``info_gain_cond`` kernels (a similarity outside
  ``FUSED_SIMS``: the reference's generic formula, ``_generic_cond``).
  Subclasses set ``_ridge`` and map cond to a gain with ``_log_gain``,
  which is strictly increasing, so the cond-space top-1 of the fused
  select IS the gain top-1."""

  @property
  def h(self) -> float:
    return _kernel_h(self.kernel_kwargs)

  def _check_kernel(self):
    _check_sim(type(self).__name__, self.kernel)

  def _generic_cond(self, state: IGState, cand_feats: torch.Tensor):
    """max(k(v, v) + ridge - |L^-1 k(S, v)|^2, 1e-12) for every candidate,
    the cross kernel's rows past the count zeroed, k(v, v) by the kernel's
    formula on the row alone (the reference's vmap)."""
    live = torch.arange(self.k_max, device=state.count.device) < \
        state.count.unsqueeze(-1)
    k_sc = torch.where(live.unsqueeze(-1),
                       self._k(state.sel_feats, cand_feats.to(
                           state.sel_feats.dtype)), 0.0)
    c = torch.linalg.solve_triangular(state.chol, k_sc, upper=False)
    c1 = cand_feats.unsqueeze(-2).to(state.sel_feats.dtype)
    k_vv = self._k(c1, c1)[..., 0, 0]
    return torch.clamp_min(k_vv + self._ridge - torch.sum(c * c, dim=-2),
                           1e-12)

  def _k(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return KERNELS[self.kernel](x, y, **dict(self.kernel_kwargs))

  # f depends only on the selected set; buffers are sized by the feature
  # width, so init takes ``d`` instead of evaluation features.
  def init_d(self, d: int, dtype=torch.float32, device=None,
             batch: tuple = ()) -> IGState:
    """The empty selection, with leading partition axes ``batch``."""
    eye = torch.eye(self.k_max, dtype=dtype, device=device)
    return IGState(
        torch.zeros((*batch, self.k_max, d), dtype=dtype, device=device),
        torch.zeros(batch, dtype=torch.int64, device=device),
        eye.expand(*batch, -1, -1).clone(),
        torch.zeros(batch, dtype=dtype, device=device))

  @staticmethod
  def _state(state) -> IGState:
    return state.inner if isinstance(state, IGShardState) else state

  def broadcast(self, state, n_part: int):
    """The same state for each of ``n_part`` partitions (every field gets a
    leading axis; a state that already has it is copied as it is)."""
    if isinstance(state, IGShardState):
      return IGShardState(self.broadcast(state.inner, n_part),
                          state.n_live.expand(n_part).clone())
    return IGState(state.sel_feats.expand(n_part, -1, -1).clone(),
                   state.count.expand(n_part).clone(),
                   state.chol.expand(n_part, -1, -1).clone(),
                   state.value.expand(n_part).clone())

  def _oracle(self, state: IGState):
    return state.sel_feats, _masked_linv(state.chol, state.count)

  # the kernels take the selection count (``live``): linv is lower-
  # triangular with only its count x count corner live, so they skip the
  # rest exactly
  def gains(self, state, cand_feats: torch.Tensor) -> torch.Tensor:
    st = self._state(state)
    if self.kernel not in dispatch.FUSED_SIMS:
      return self._log_gain(self._generic_cond(st, cand_feats))
    sel, linv = self._oracle(st)
    fn = dispatch.resolve("info_gain_cond", self.backend)
    cond = fn(sel, linv, cand_feats, kernel=self.kernel, h=self.h,
              ridge=self._ridge, live=st.count)
    return self._log_gain(cond)

  def select(self, state, cand_feats: torch.Tensor, feasible: torch.Tensor):
    """Select step: (best gain, int64 candidate index), one fused launch
    for a fused similarity."""
    if self.kernel not in dispatch.FUSED_SIMS:
      return masked_top1(self.gains(state, cand_feats), feasible)
    st = self._state(state)
    sel, linv = self._oracle(st)
    fn = dispatch.resolve_select("info_gain_cond", self.backend)
    cond, idx = fn(sel, linv, cand_feats, feasible, kernel=self.kernel,
                   h=self.h, ridge=self._ridge, live=st.count)
    return self._log_gain(torch.clamp_min(cond, 1e-12)), idx

  def update(self, state, feat: torch.Tensor):
    """S <- S + {feat}; feat is ((P,) d).  Writes row ``count`` of the
    Cholesky as [c_0 .. c_{count-1}, diag, 0 ...] with k(v, v) computed by
    the kernel's formula (for rbf it need not round to exactly 1), as the
    reference does.  At count == k_max the write lands on the last row and
    the diagonal entry is dropped, as ``dynamic_update_slice`` and an
    out-of-range ``.at[].set`` do there; the greedy loops refuse more
    steps than k_max, so that state is never kept."""
    if isinstance(state, IGShardState):
      return IGShardState(self.update(state.inner, feat), state.n_live)
    k_max = self.k_max
    ar = torch.arange(k_max, device=feat.device)
    i = state.count
    live = ar < i.unsqueeze(-1)                              # ((P,) k_max)
    f1 = feat.unsqueeze(-2).to(state.sel_feats.dtype)        # ((P,) 1, d)
    k_sc = torch.where(live, self._k(state.sel_feats, f1)[..., 0], 0.0)
    c = torch.linalg.solve_triangular(state.chol, k_sc.unsqueeze(-1),
                                      upper=False)[..., 0]
    k_vv = self._k(f1, f1)[..., 0, 0]
    diag = torch.sqrt(torch.clamp_min(
        k_vv + self._ridge - _sq_norm(c), 1e-12))
    row = torch.where(live, c, 0.0)
    row = torch.where(ar == i.unsqueeze(-1), diag.unsqueeze(-1), row)
    at = i.clamp_max(k_max - 1)[..., None, None]
    chol = state.chol.scatter(-2, at.expand(*i.shape, 1, k_max),
                              row.unsqueeze(-2))
    d = f1.shape[-1]
    sel = state.sel_feats.scatter(-2, at.expand(*i.shape, 1, d), f1)
    gain = self._log_gain(torch.clamp_min(diag * diag, 1e-12))
    return IGState(sel, i + 1, chol, state.value + gain)

  def value(self, state) -> torch.Tensor:
    return self._state(state).value


@dataclasses.dataclass(frozen=True)
class InformationGain(_IncrementalCholesky):
  """f(S) = 0.5 logdet(I + sigma^-2 K_SS); monotone submodular.

  Marginal gain of v: 0.5 log(cond(v) / sigma^2), cond through the
  ``info_gain_cond`` kernels with ridge = sigma^2; the fused select returns
  only the winning (cond, index) pair.
  """
  monotone = True

  k_max: int
  kernel: str = "rbf"
  kernel_kwargs: tuple = (("h", 0.75),)
  sigma: float = 1.0
  backend: str = "auto"

  def __post_init__(self):
    self._check_kernel()

  @property
  def _ridge(self) -> float:
    return self.sigma ** 2

  def _log_gain(self, cond: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.log(cond / self._ridge)

  def init(self, eval_feats: torch.Tensor,
           eval_mask: torch.Tensor | None = None) -> IGShardState:
    """Sharded-protocol surface (core/greedi.py): f ignores the evaluation
    set, so only its live mass is recorded (see ``IGShardState``); a
    (P, ne, d) evaluation block gives a state per partition."""
    batch, (ne, d) = eval_feats.shape[:-2], eval_feats.shape[-2:]
    if eval_mask is None:
      n_live = torch.full(batch, float(ne), dtype=torch.float32,
                          device=eval_feats.device)
    else:
      # repro: allow(T8): a count of 0/1 mask entries, exact in float32 in any order
      n_live = torch.sum(eval_mask.to(torch.float32), dim=-1)
    return IGShardState(self.init_d(d, device=eval_feats.device,
                                    batch=batch), n_live)

  def partial_stats(self, state, cand_feats: torch.Tensor):
    """(live-count-weighted gains ((P,) nc), live count ((P,))): every
    shard computes the same gains from the shared candidate block, so the
    weighted sum over shards over the weighted count reproduces them for
    any liveness weighting."""
    n_live = (state.n_live if isinstance(state, IGShardState)
              else torch.ones((), dtype=torch.float32,
                              device=cand_feats.device))
    return self.gains(state, cand_feats) * n_live.unsqueeze(-1), n_live


@dataclasses.dataclass(frozen=True)
class LogDetDPP(_IncrementalCholesky):
  """f(S) = logdet(K_S) on the same incremental Cholesky, ridge = jitter.

  Non-monotone once conditional variances drop below 1: run its greedy
  with ``stop_nonpositive=True``.
  """
  monotone = False

  k_max: int
  kernel: str = "rbf"
  kernel_kwargs: tuple = (("h", 0.75),)
  jitter: float = 1e-6
  backend: str = "auto"

  def __post_init__(self):
    self._check_kernel()

  @property
  def _ridge(self) -> float:
    return self.jitter

  def _log_gain(self, cond: torch.Tensor) -> torch.Tensor:
    return torch.log(cond)


# ---------------------------------------------------------------------------
# Graph cut (Sec. 6.3; non-monotone) -- index-based, explicit weight matrix
# ---------------------------------------------------------------------------

_SYM_BLOCK = 4096  # rows and columns of W per block of the in-place pass


def symmetrize_(w: torch.Tensor) -> torch.Tensor:
  """W <- 0.5 (W + W^T) with a zero diagonal, IN PLACE, block by block
  (the temporaries are 4096 x 4096, not another n x n copy: W is 5.39 GB
  at n = 36692).  Every entry is the reference's 0.5 * (w_ij + w_ji) to the
  bit."""
  n = w.shape[0]
  for i0 in range(0, n, _SYM_BLOCK):
    i1 = min(i0 + _SYM_BLOCK, n)
    for j0 in range(i0, n, _SYM_BLOCK):
      j1 = min(j0 + _SYM_BLOCK, n)
      t = 0.5 * (w[i0:i1, j0:j1] + w[j0:j1, i0:i1].T)
      w[i0:i1, j0:j1].copy_(t)
      w[j0:j1, i0:i1].copy_(t.T)
  w.diagonal().zero_()
  return w


class CutState(NamedTuple):
  w: torch.Tensor                  # (n, n) symmetric weights, shared
  in_s: torch.Tensor               # ((P,) n) float32 indicator of S
  value: torch.Tensor              # ((P,)) float32 f(S)
  ind: torch.Tensor | None = None  # ((P,) n) node indicator of the induced
  #                                  subgraph each partition evaluates on
  #                                  (local evaluation); None: the graph


@dataclasses.dataclass(frozen=True)
class GraphCut:
  """f(S) = sum_{i in S, j not in S} w_ij on an explicit graph.

  Candidates are node indices encoded as one-hot rows, so the generic
  greedy loop (which traffics in "feature" rows) applies unchanged: the
  "feature" of node v is e_v.  The per-node gain sweep deg - 2 W x ==
  W (1 - 2x) runs through the ``graph_cut_gain`` kernel, one pass over W
  for every partition of a step; ``gains`` maps it onto the candidate rows
  with one product over the one-hot block, and ``update`` recomputes the
  chosen node's gain with one more pass (as the reference does).

  Local evaluation (the decomposable mode of Sec. 4.5, Fig. 9: each
  machine cuts its partition's induced subgraph) keeps ONE shared W and a
  per-partition node indicator ``ind``: the kernel's column vector is
  ind * (1 - 2x), whose products on every node of the partition are those
  of the reference's masked copy W * ind ind^T.  No (m, n, n) block exists.

  ``assume_node_order=True`` routes the select step through the fused
  node-space top-1 kernel (``graph_cut_select``) and maps the winning node
  back to its first feasible candidate row.  It is opt-in because node-space
  tie-breaking matches the candidate-space argmax only when candidates are
  laid out in node order (``eye(n)``, the centralized greedy): for permuted
  one-hot layouts and exactly tied gains (integer or binary weights) the
  two orders pick different rows.  The default select reduces in candidate
  space and is exact for any layout.
  """
  monotone = False  # cut gains go negative: greedy(mode="lazy") falls back

  backend: str = "auto"
  assume_node_order: bool = False

  def init_w(self, w: torch.Tensor) -> CutState:
    """Symmetrize W and zero its diagonal, IN PLACE (the reference returns a
    new matrix; at n = 36692 a second copy would be another 5.39 GB), and
    return the empty-set state over the whole graph.  Idempotent, so
    calling it again on the prepared W changes nothing."""
    return self.init_induced(symmetrize_(w))

  def init_induced(self, w: torch.Tensor,
                   ind: torch.Tensor | None = None) -> CutState:
    """The empty-set state over a W that ``init_w`` prepared (W is not
    touched): the whole graph, or with ``ind`` ((P,) n) the subgraph each
    partition's nodes induce."""
    n = w.shape[-1]
    lead = () if ind is None else tuple(ind.shape[:-1])
    return CutState(
        w, torch.zeros((*lead, n), dtype=torch.float32, device=w.device),
        torch.zeros(lead, dtype=torch.float32, device=w.device),
        None if ind is None else ind.to(torch.float32))

  def broadcast(self, state: CutState, n_part: int) -> CutState:
    """The same state for each of ``n_part`` partitions; W stays shared."""
    return CutState(state.w, state.in_s.expand(n_part, -1).clone(),
                    state.value.expand(n_part).clone(),
                    None if state.ind is None
                    else state.ind.expand(n_part, -1))

  def node_gains(self, state: CutState) -> torch.Tensor:
    """((P,) n) float32 gain of every node: one pass over W."""
    fn = dispatch.resolve("graph_cut_gain", self.backend)
    return fn(state.w, state.in_s, state.ind)

  def gains(self, state: CutState, cand_feats: torch.Tensor) -> torch.Tensor:
    # cand_feats ((P,) nc, n) one-hot rows (zero rows for holes)
    node_gain = self.node_gains(state)
    return (cand_feats.to(torch.float32)
            @ node_gain.unsqueeze(-1)).squeeze(-1)

  def select(self, state: CutState, cand_feats: torch.Tensor,
             feasible: torch.Tensor):
    if not self.assume_node_order:
      return masked_top1(self.gains(state, cand_feats), feasible)
    fn = dispatch.resolve_select("graph_cut_gain", self.backend)
    cf = cand_feats.to(torch.float32)
    # candidate feasibility projected onto the nodes (one-hot rows)
    node_ok = (feasible.to(torch.float32).unsqueeze(-2) @ cf).squeeze(-2) > 0
    best, node = fn(state.w, state.in_s, node_ok, state.ind)
    # winning node -> its first feasible candidate row
    col = torch.gather(cf, -1, node.reshape(*node.shape, 1, 1).expand(
        *cf.shape[:-1], 1)).squeeze(-1)
    hit = feasible & (col > 0)
    return best, masked_top1(hit.to(torch.float32),
                             torch.ones_like(hit))[1]

  def update(self, state: CutState, feat: torch.Tensor) -> CutState:
    f = feat.to(torch.float32)
    # repro: allow(T8): graph cut runs stacked only (greedi_reference, greedy), never over a process mesh
    gain = torch.sum(f * self.node_gains(state), dim=-1)
    return CutState(state.w, torch.maximum(state.in_s, f),
                    state.value + gain, state.ind)

  def value(self, state: CutState) -> torch.Tensor:
    return state.value


# ---------------------------------------------------------------------------
# Modular (additive) objective: a sanity baseline, GreeDi is exactly optimal
# ---------------------------------------------------------------------------


class ModState(NamedTuple):
  weights: torch.Tensor   # (d,) fixed linear weights, shared
  value: torch.Tensor     # ((P,)) f(S)


@dataclasses.dataclass(frozen=True)
class Modular:
  """f(S) = sum_{v in S} relu(w . x_v): modular, so distributed ==
  centralized."""
  monotone = True

  def init_w(self, weights: torch.Tensor) -> ModState:
    return ModState(weights, torch.zeros((), dtype=weights.dtype,
                                         device=weights.device))

  def broadcast(self, state: ModState, n_part: int) -> ModState:
    """The same state for each of ``n_part`` partitions; w stays shared."""
    return ModState(state.weights, state.value.expand(n_part).clone())

  def gains(self, state: ModState, cand_feats: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(cand_feats.to(state.weights.dtype)
                           @ state.weights, 0.0)

  def select(self, state: ModState, cand_feats: torch.Tensor,
             feasible: torch.Tensor):
    return masked_top1(self.gains(state, cand_feats), feasible)

  def update(self, state: ModState, feat: torch.Tensor) -> ModState:
    return ModState(state.weights, state.value + torch.clamp_min(
        feat.to(state.weights.dtype) @ state.weights, 0.0))

  def value(self, state: ModState) -> torch.Tensor:
    return state.value


# ---------------------------------------------------------------------------
# Warm-start bound maintainers (the selection service's cross-epoch tables)
# ---------------------------------------------------------------------------
#
# The selection service (repro_torch/service/) carries, per document, an
# upper bound on its empty-set marginal gain across epochs, so round 1's
# lazy greedy can skip its step-0 full pass (``greedy(warm_bounds=...)``).
# A maintainer packages the objective-specific math:
#
#   * ``append_update`` -- one (new rows x block) pass giving the mass the
#     new documents add to every older document's bound and the new
#     documents' own bounds (the store places and reduces them);
#   * ``epoch_bounds``  -- carried table entries -> per-item empty-set gain
#     bounds under a shard evaluating ``n_live`` live rows.
#
# Maintainers are registered per objective type; each one's ``supports``
# gates on the instance's configuration, and an objective that fails it
# gets none: the service then runs cold, which is always exact.


@dataclasses.dataclass(frozen=True)
class SumFormBoundMaintainer:
  """Sum-form singleton-gain bounds: ``table[i] = sum_e relu(sim(e, i))``.

  Valid for facility location with a non-negative baseline (doc i's
  empty-set gain under an evaluation set P is
  ``(1/|P|) sum_{e in P} relu(sim(e, i) - baseline) <= table[i] / |P|``)
  and for saturated coverage (its per-point contribution
  ``min(relu(sim), cap_e)`` is at most relu(sim) whatever the partition):
  one maintainer, two objectives.

  ``supports_sieve``: the same sums power the store's standing threshold
  sieves (select-on-append): each new row's summed ``sums`` is its
  standing singleton gain, the sieve's admission gain.
  """
  oracle: str = "bound_update"
  sums_global: bool = False
  supports_sieve: bool = True

  def supports(self, objective: Any) -> bool:
    """The similarity must be one the ``bound_update`` pass implements,
    and a facility-location baseline must not be negative (relu(sim - b)
    would exceed relu(sim))."""
    if getattr(objective, "kernel", None) not in dispatch.FUSED_SIMS:
      return False
    if float(getattr(objective, "baseline", 0.0)) < 0.0:
      return False
    return True

  def append_update(self, new_rows: torch.Tensor, block_feats: torch.Tensor,
                    new_valid: torch.Tensor, block_valid: torch.Tensor, *,
                    kernel: str, h: float, backend: str | None = None):
    """(add ((m,) nb_block), sums ((m,) nb_new)): the mass the new rows
    credit to each block column, and each new row's bound over the block
    (per shard when the block is (m, npp, d); the caller sums the shards)."""
    fn = dispatch.resolve(self.oracle, backend or "auto")
    return fn(new_rows, block_feats, new_valid, block_valid, kernel=kernel,
              h=h)

  def epoch_bounds(self, table: torch.Tensor,
                   n_live: torch.Tensor) -> torch.Tensor:
    """Sum-form entries -> mean-form empty-set bounds for a shard whose
    evaluation set has ``n_live`` live rows."""
    return table / torch.clamp_min(n_live, 1.0)


@dataclasses.dataclass(frozen=True)
class InfoGainPriorBoundMaintainer:
  """The exact empty-set gain of information gain,
  ``0.5 log(1 + k(v, v) / sigma^2)``: independent of the evaluation set,
  the partition and every other document.  Appends set the new rows'
  bounds and move nobody else's (``add == 0``); ``epoch_bounds`` is the
  identity.  ``sums_global``: each new row's bound is complete as
  computed, so the store must not sum it over shards.  No sum-form
  singleton gains, so no standing sieve (``supports_sieve``): the service
  answers queries from its last epoch."""
  sigma: float = 1.0
  sums_global: bool = True
  supports_sieve: bool = False

  def supports(self, objective: Any) -> bool:
    # k(v, v) from the row alone: 1 for rbf, |v|^2 for linear
    return getattr(objective, "kernel", None) in ("rbf", "linear")

  def for_objective(self, objective: Any) -> "InfoGainPriorBoundMaintainer":
    """Bind the objective's noise level (``bound_maintainer_for`` hook)."""
    return dataclasses.replace(self, sigma=float(objective.sigma))

  def append_update(self, new_rows: torch.Tensor, block_feats: torch.Tensor,
                    new_valid: torch.Tensor, block_valid: torch.Tensor, *,
                    kernel: str, h: float, backend: str | None = None):
    del block_valid, h, backend  # a prior bound: no cross terms
    if kernel == "rbf":
      k_vv = torch.ones(new_rows.shape[:1], dtype=torch.float32,
                        device=new_rows.device)
    else:
      # repro: allow(T8): a norm over each new row's d features, one output per row (test_cuda_row_norms_layout_independent)
      k_vv = torch.sum(new_rows.float() ** 2, dim=-1)
    sums = 0.5 * torch.log1p(k_vv / self.sigma ** 2) * new_valid.float()
    add = torch.zeros(block_feats.shape[:-1], dtype=torch.float32,
                      device=block_feats.device)
    return add, sums

  def epoch_bounds(self, table: torch.Tensor,
                   n_live: torch.Tensor) -> torch.Tensor:
    del n_live  # a per-item prior: already mean-form
    return table


_BOUND_MAINTAINERS: dict[type, Any] = {}


def register_bound_maintainer(obj_type: type, maintainer: Any) -> None:
  """Register (or replace) the warm-start bound maintainer of an objective
  type."""
  _BOUND_MAINTAINERS[obj_type] = maintainer


def bound_maintainer_for(objective: Any) -> Any | None:
  """The registered maintainer for ``objective``, or None when its type or
  its configuration (the maintainer's ``supports``) admits no maintained
  warm start: None means "run cold", which is always exact."""
  maintainer = _BOUND_MAINTAINERS.get(type(objective))
  if maintainer is None:
    return None
  supports = getattr(maintainer, "supports", None)
  if supports is not None and not supports(objective):
    return None
  bind = getattr(maintainer, "for_objective", None)
  if bind is not None:
    maintainer = bind(objective)
  return maintainer


register_bound_maintainer(FacilityLocation, SumFormBoundMaintainer())
register_bound_maintainer(SaturatedCoverage, SumFormBoundMaintainer())
register_bound_maintainer(InformationGain, InfoGainPriorBoundMaintainer())


# ---------------------------------------------------------------------------
# Exact evaluation by replay (tests and small benchmarks)
# ---------------------------------------------------------------------------


def set_value(objective: Any, state0, feats: torch.Tensor, idx,
              mask: torch.Tensor | None = None) -> torch.Tensor:
  """f({feats[i] for i in idx}) by replaying updates from ``state0``;
  entries whose ``mask`` is False are skipped (their state is kept, as the
  reference's masked scan does).  ``idx`` and ``mask`` are (k,); see
  ``greedi.set_value_feats`` for an explicit feature block."""
  from repro_torch.core.greedy import where_state
  idx = torch.as_tensor(idx, device=feats.device).to(torch.int64)
  if mask is None:
    mask = torch.ones(idx.shape, dtype=torch.bool, device=feats.device)
  mask = torch.as_tensor(mask, device=feats.device).to(torch.bool)
  state = state0
  for t in range(idx.shape[0]):
    state = where_state(mask[t], objective.update(
        state, feats.index_select(0, idx[t:t + 1])[0]), state)
  return objective.value(state)
