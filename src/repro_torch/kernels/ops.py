"""Public kernel entry points and their registration (the port of
``src/repro/kernels/ops.py``).

The reference's wrappers pad operands to tile multiples (``cov`` with +inf,
``ok`` with 0).  The CUDA kernels mask ragged edges themselves, so these
wrappers pass tensors through as they are.  Each kernel wrapper counts its
launches (``launch_counts``), so a run can show that its main path went
through the kernels.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.kernels import colsum as _cs
from repro_torch.kernels import coverage_gain as _cg
from repro_torch.kernels import dispatch, ref
from repro_torch.kernels import facility_gain as _fg
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import graph_cut_gain as _gc
from repro_torch.kernels import info_gain as _ig
from repro_torch.kernels import pairwise as _pw
from repro_torch.kernels import ring
from repro_torch.kernels import select_top1 as _st
from repro_torch.kernels import sieve as _sv

coverage_gain = _cg.coverage_gain
coverage_select = _st.coverage_select
facility_gain = _fg.facility_gain
facility_select = _st.facility_select
graph_cut_gain = _gc.graph_cut_gain
graph_cut_select = _st.graph_cut_select
graph_cut_select_batched = _st.graph_cut_select_batched
info_gain_cond = _ig.info_gain_cond
info_select = _st.info_select
pairwise = _pw.pairwise
relu_colsum = _cs.relu_colsum
sieve_scan = _sv.sieve_scan

# kernel name -> (wrapper module, its counter attribute)
_COUNTED = {"pairwise": (_pw, "launches"), "facility_gain": (_fg, "launches"),
            "facility_select": (_st, "launches"),
            "coverage_gain": (_cg, "launches"),
            "coverage_select": (_st, "coverage_launches"),
            "info_gain_cond": (_ig, "launches"),
            "info_select": (_st, "info_launches"),
            "graph_cut_gain": (_gc, "launches"),
            "graph_cut_select": (_st, "graph_cut_launches"),
            "flash_attention": (_fa, "launches"),
            "relu_colsum": (_cs, "launches"),
            "sieve_admit": (_sv, "launches")}


def launch_counts() -> dict[str, int]:
  """Kernel launches through each wrapper since the last reset."""
  return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTED.items()}


def reset_launch_counts() -> None:
  for mod, attr in _COUNTED.values():
    setattr(mod, attr, 0)
  _fa.tc_launches = 0
  ring.mode_launches.clear()


def _cuda_only(fn):
  """The kernel wrapper, refusing CPU tensors instead of taking the plain
  version (the ``cuda`` backend never falls back)."""

  @functools.wraps(fn)
  def wrapped(*args, **kwargs):
    if not args[0].is_cuda:
      raise ValueError(f"{fn.__name__}: backend 'cuda' needs CUDA tensors, "
                       f"got {args[0].device}")
    return fn(*args, **kwargs)

  return wrapped


def _bound_update(sim):
  """``bound_update`` over the similarity implementation ``sim``."""

  def bound_update(new_rows: torch.Tensor, block_feats: torch.Tensor,
                   new_valid: torch.Tensor, block_valid: torch.Tensor, *,
                   kernel: str = "linear", h: float = 0.75):
    """The append-time warm-bound pass of the selection service (the port
    of ``src/repro/kernels/ops.py`` ``bound_update``): one (nb_new x
    nb_block) similarity sweep serving both sides of a corpus append,

        add[j]  = sum_i relu(sim(new_i, block_j)) -- mass credited to doc j
        sums[i] = sum_j relu(sim(new_i, block_j)) -- new doc i's own bound,
                                                     over this block

    with invalid rows and columns (chunk padding, holes) contributing
    nothing.  ``block_feats`` may be the (m, npp, d) stacked shards: the
    new rows are shared and the result is per shard, ``add`` (m, npp) and
    ``sums`` (m, nb_new), the shape of the reference's shard-local sums
    before their psum.  A plain wrapper over the ``pairwise`` kernel (the
    (nb_new, nb_block) block is a temporary; fusing relu and the sums into
    the kernel's epilogue is later work, ROADMAP.md).
    """
    s = sim(new_rows, block_feats, kernel=kernel, h=h)
    s.clamp_min_(0.0)
    s.mul_(new_valid.to(s.dtype).unsqueeze(-1))
    s.mul_(block_valid.to(s.dtype).unsqueeze(-2))
    return s.sum(dim=-2), s.sum(dim=-1)

  return bound_update


def _batched(select, name: str, rank: int):
  """The reference's query-batched select ``name``: ``select`` with its
  per-query state carrying a leading axis of B queries over the shared
  corpus-side operands (one launch for the batch; ``rank`` is the rank of
  one query's ``cand_ok``, the last argument)."""

  def batched(*args, **kwargs):
    ok = args[-1]
    if ok.dim() != rank + 1:
      raise ValueError(f"{name}: per-query state must carry a leading "
                       f"batch axis, got cand_ok of shape {tuple(ok.shape)}")
    return select(*args, **kwargs)

  batched.__name__ = name
  batched.__doc__ = (f"``{name}``: per-query state (B, ...), corpus-side "
                     "operands shared -> ((B,) best, (B,) index).")
  return batched


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    backend: str = "auto") -> torch.Tensor:
  """GQA attention (B, H, L, dh) against (B, Hkv, L, dh) (the port of
  ``src/repro/kernels/ops.py`` ``flash_attention``): ``backend`` "cuda"
  launches ``csrc/flash_attention_tc.cu`` (bfloat16) or
  ``csrc/flash_attention.cu`` (float32) and raises on CPU tensors, "ref"
  runs ``ref.mha_ref``, "auto" picks by the tensors' device.  No padding:
  the kernel masks ragged lengths itself."""
  return dispatch.resolve("flash_attention", backend)(q, k, v, causal=causal,
                                                      scale=scale)


bound_update = _bound_update(pairwise)
sieve_update = ref.sieve_update_with(pairwise, sieve_scan)
facility_select_batched = _batched(facility_select,
                                   "facility_select_batched", 1)
coverage_select_batched = _batched(coverage_select,
                                   "coverage_select_batched", 1)
info_select_batched = _batched(info_select, "info_select_batched", 1)
dispatch.register("bound_update", cuda=_bound_update(_cuda_only(pairwise)),
                  ref=_bound_update(ref.pairwise_ref), auto=bound_update)
dispatch.register("coverage_gain", cuda=_cuda_only(coverage_gain),
                  ref=ref.coverage_gain_ref, auto=coverage_gain)
dispatch.register_select("coverage_gain", cuda=_cuda_only(coverage_select),
                         ref=ref.coverage_select_ref, auto=coverage_select)
dispatch.register("facility_gain", cuda=_cuda_only(facility_gain),
                  ref=ref.facility_gain_ref, auto=facility_gain)
dispatch.register("pairwise", cuda=_cuda_only(pairwise),
                  ref=ref.pairwise_ref, auto=pairwise)
dispatch.register_select("facility_gain", cuda=_cuda_only(facility_select),
                         ref=ref.facility_select_ref, auto=facility_select)
dispatch.register("info_gain_cond", cuda=_cuda_only(info_gain_cond),
                  ref=ref.info_gain_cond_ref, auto=info_gain_cond)
dispatch.register_select("info_gain_cond", cuda=_cuda_only(info_select),
                         ref=ref.info_select_ref, auto=info_select)
dispatch.register("graph_cut_gain", cuda=_cuda_only(graph_cut_gain),
                  ref=ref.graph_cut_gain_ref, auto=graph_cut_gain)
dispatch.register_select("graph_cut_gain", cuda=_cuda_only(graph_cut_select),
                         ref=ref.graph_cut_select_ref, auto=graph_cut_select)
dispatch.register("relu_colsum", cuda=_cuda_only(relu_colsum),
                  ref=ref.relu_colsum_ref, auto=relu_colsum)
dispatch.register("flash_attention", cuda=_cuda_only(_fa.flash_attention),
                  ref=ref.mha_ref, auto=_fa.flash_attention)
dispatch.register("sieve_update",
                  cuda=ref.sieve_update_with(_cuda_only(pairwise),
                                             _cuda_only(sieve_scan)),
                  ref=ref.sieve_update_ref, auto=sieve_update)
dispatch.register_select_batched(
    "facility_gain", cuda=_cuda_only(facility_select_batched),
    ref=_batched(ref.facility_select_ref, "facility_select_batched", 1),
    auto=facility_select_batched)
dispatch.register_select_batched(
    "coverage_gain", cuda=_cuda_only(coverage_select_batched),
    ref=_batched(ref.coverage_select_ref, "coverage_select_batched", 1),
    auto=coverage_select_batched)
dispatch.register_select_batched(
    "info_gain_cond", cuda=_cuda_only(info_select_batched),
    ref=_batched(ref.info_select_ref, "info_select_batched", 1),
    auto=info_select_batched)
dispatch.register_select_batched(
    "graph_cut_gain", cuda=_cuda_only(graph_cut_select_batched),
    ref=ref.graph_cut_select_ref, auto=graph_cut_select_batched)


# ---------------------------------------------------------------------------
# entry points of the hazard analyzer (repro_torch.analysis): every oracle
# family above at the reference's representative shapes and names, with the
# T3 mask annotations.  Row sizes are distinct from d and from each other so
# a reduced-axis size match really means "a pad-and-mask row axis".  Each
# builder resolves "auto", so the card runs the CUDA routes (every kernel of
# the ten, plus the sieve scan) and the CPU their plain versions.  No oracle
# reads anything back: every budget is 0 host syncs.
# ---------------------------------------------------------------------------

_NE, _NC, _AB, _D = 384, 96, 48, 16  # eval rows, candidates, append chunk, d
# the query-batched select family: a leading batch axis of _B queries,
# distinct from every row size
_B = 3


class _Operands:
  """Operands of one entry from a numpy seed, on ``device``."""

  def __init__(self, device, seed: int):
    self.g = np.random.default_rng(seed)
    self.dev = torch.device(device)

  def t(self, a, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), device=self.dev).to(dtype)

  def feats(self, *shape) -> torch.Tensor:
    return self.t(self.g.standard_normal(shape) / np.sqrt(shape[-1]))

  def pos(self, *shape) -> torch.Tensor:
    return self.t(self.g.uniform(0.0, 0.5, shape))

  def mask(self, *shape, p: float = 0.8) -> torch.Tensor:
    return self.t(self.g.uniform(size=shape) < p)

  def linv(self, *lead, k: int = 8) -> torch.Tensor:
    """(..., k, k) inverse Cholesky factors of k x k SPD matrices."""
    a = self.g.standard_normal((*lead, k, k))
    spd = a @ np.swapaxes(a, -1, -2) / k + np.eye(k)
    return self.t(np.linalg.inv(np.linalg.cholesky(spd)))


def _ep(name, builder):
  dispatch.register_entry_point(name, builder)


def _spec(fn, args, mask_args=(), row_sizes=()):
  return dispatch.TraceSpec(fn=fn, args=tuple(args), mask_args=mask_args,
                            row_sizes=row_sizes, sync_budget=0)


def _fl_args(o, batch=None):
  lead = () if batch is None else (batch,)
  return (o.feats(_NE, _D), o.feats(_NC, _D), o.pos(*lead, _NE),
          o.mask(*lead, _NE))


_ep("oracle:facility_gain", lambda dev: _spec(
    dispatch.resolve("facility_gain", "auto"), _fl_args(_Operands(dev, 1)),
    (3,), (_NE,)))

_ep("select:facility_gain", lambda dev: (lambda o: _spec(
    dispatch.resolve_select("facility_gain", "auto"),
    (*_fl_args(o), o.mask(_NC)), (3, 4), (_NE, _NC)))(_Operands(dev, 2)))

_ep("oracle:coverage_gain", lambda dev: (lambda o: _spec(
    dispatch.resolve("coverage_gain", "auto"),
    (o.feats(_NE, _D), o.feats(_NC, _D), o.pos(_NE), o.pos(_NE) + 0.5,
     o.mask(_NE)), (4,), (_NE,)))(_Operands(dev, 3)))

_ep("select:coverage_gain", lambda dev: (lambda o: _spec(
    dispatch.resolve_select("coverage_gain", "auto"),
    (o.feats(_NE, _D), o.feats(_NC, _D), o.pos(_NE), o.pos(_NE) + 0.5,
     o.mask(_NE), o.mask(_NC)), (4, 5), (_NE, _NC)))(_Operands(dev, 4)))

# info-gain's eval-set independence means no row mask on the gain side; the
# select side masks the candidate axis through cand_ok
_ep("oracle:info_gain_cond", lambda dev: (lambda o: _spec(
    dispatch.resolve("info_gain_cond", "auto"),
    (o.feats(8, _D), o.linv(), o.feats(_NC, _D))))(_Operands(dev, 5)))

_ep("select:info_gain_cond", lambda dev: (lambda o: _spec(
    dispatch.resolve_select("info_gain_cond", "auto"),
    (o.feats(8, _D), o.linv(), o.feats(_NC, _D), o.mask(_NC)), (3,),
    (_NC,)))(_Operands(dev, 6)))

# graph-cut contracts the full adjacency (no pad-and-mask rows at this
# surface; node_ok only gates the top-1), so T3 has nothing to audit here
_ep("oracle:graph_cut_gain", lambda dev: (lambda o: _spec(
    dispatch.resolve("graph_cut_gain", "auto"),
    (o.pos(_NC, _NC), o.mask(_NC, p=0.3))))(_Operands(dev, 7)))

_ep("select:graph_cut_gain", lambda dev: (lambda o: _spec(
    dispatch.resolve_select("graph_cut_gain", "auto"),
    (o.pos(_NC, _NC), o.mask(_NC, p=0.3), o.mask(_NC))))(_Operands(dev, 8)))

# the query-batched select family: per-query state carries a leading batch
# axis; the row-axis reductions and mask roots are the unbatched oracles'
_ep("select_batched:facility_gain", lambda dev: (lambda o: _spec(
    dispatch.resolve_select_batched("facility_gain", "auto"),
    (*_fl_args(o, _B), o.mask(_B, _NC)), (3, 4), (_NE, _NC)))(
        _Operands(dev, 9)))

_ep("select_batched:coverage_gain", lambda dev: (lambda o: _spec(
    dispatch.resolve_select_batched("coverage_gain", "auto"),
    (o.feats(_NE, _D), o.feats(_NC, _D), o.pos(_B, _NE), o.pos(_NE) + 0.5,
     o.mask(_B, _NE), o.mask(_B, _NC)), (4, 5), (_NE, _NC)))(
         _Operands(dev, 10)))

_ep("select_batched:info_gain_cond", lambda dev: (lambda o: _spec(
    dispatch.resolve_select_batched("info_gain_cond", "auto"),
    (o.feats(_B, 8, _D), o.linv(_B), o.feats(_NC, _D), o.mask(_B, _NC)),
    (3,), (_NC,)))(_Operands(dev, 11)))

_ep("select_batched:graph_cut_gain", lambda dev: (lambda o: _spec(
    dispatch.resolve_select_batched("graph_cut_gain", "auto"),
    (o.pos(_NC, _NC), o.mask(_B, _NC, p=0.3), o.mask(_B, _NC))))(
        _Operands(dev, 12)))

_ep("oracle:pairwise", lambda dev: (lambda o: _spec(
    dispatch.resolve("pairwise", "auto"),
    (o.feats(_AB, _D), o.feats(_NC, _D))))(_Operands(dev, 13)))

_ep("oracle:bound_update", lambda dev: (lambda o: _spec(
    dispatch.resolve("bound_update", "auto"),
    (o.feats(_AB, _D), o.feats(_NE, _D), o.mask(_AB), o.mask(_NE)), (2, 3),
    (_AB, _NE)))(_Operands(dev, 14)))


def _sieve_spec(dev) -> dispatch.TraceSpec:
  """Admission of one chunk into 4 buckets of 8 slots, half of them
  filled; sieve admission is per row (a scan over the chunk), its row-axis
  work is gather / scatter bookkeeping, so only the taint roots matter."""
  o = _Operands(dev, 15)
  t, k = 4, 8
  cnt = np.array([0, 3, 5, 8])
  sgid = np.where(np.arange(k)[None] < cnt[:, None],
                  1000 + np.arange(t * k).reshape(t, k), -1)
  rgids = np.where(o.g.uniform(size=_AB) < 0.9, np.arange(_AB), -1)
  return _spec(
      dispatch.resolve("sieve_update", "auto"),
      (o.feats(_AB, _D), o.pos(_AB) + 0.5, o.t(rgids, torch.int64),
       o.t(rgids >= 0, torch.bool), o.t(0.25 * 2.0 ** np.arange(t)),
       o.t(sgid, torch.int64), o.pos(t, k) * o.t(sgid >= 0),
       o.feats(t, k, _D), o.t(cnt, torch.int64)), (2, 3))


_ep("oracle:sieve_update", _sieve_spec)

# head width 32: the smallest the kernel is built for (HEAD_DIMS)
_ep("oracle:flash_attention", lambda dev: (lambda o: _spec(
    flash_attention, (o.feats(1, 2, 64, 32), o.feats(1, 2, 64, 32),
                      o.feats(1, 2, 64, 32))))(_Operands(dev, 16)))
