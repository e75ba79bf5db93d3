"""Fused greedy select steps: the ports of the TPU kernels
``src/repro/kernels/select_top1.py`` ``facility_select_pallas``,
``coverage_select_pallas`` and ``info_select_pallas``.

The greedy step only needs the masked top-1 of the facility gains, so the
kernel returns (best gain, index) per partition: candidates with ``ok`` false
score ``NEG``, the larger gain wins, ties go to the lowest index, and with no
feasible candidate the answer is (NEG, 0).  The CUDA kernel is
``csrc/facility.cu`` (the gains body with a top-1 epilogue and a
deterministic second stage in place of the TPU's sequential running best,
in the ring mode ``facility_gain.operands`` reports; see the header
there).  Its plain version is ``ref.facility_select_ref``.

``coverage_select`` is the same step for saturated coverage: the fused
top-1 of ``coverage_gain`` with the same floor, tie and empty rules, its
kernel the coverage epilogue of ``csrc/facility.cu`` and its plain version
``ref.coverage_select_ref``.  Each operand carries the partition axis or is
shared (stride 0), so the same call serves the reference's
``coverage_select_batched``: B per-query covers, masks and oks over one
shared block and cap.

``info_select`` is the information-gain / DPP step: the top-1
conditional variance, infeasible candidates at 0.0, (0.0, 0) when nothing
is feasible; the caller maps the winning cond through its log.  Its kernel
is the select entry of ``csrc/info_gain.cu`` and its plain version
``ref.info_select_ref``.

``graph_cut_select`` is the graph-cut step in node space: the top-1 of the
node cut gains over ``node_ok`` with the facility rules (NEG floor, lowest
node on ties, (NEG, 0) when nothing is feasible).  Its kernel is the select
entry of ``csrc/graph_cut.cu`` (the gains pass with a per-block top-1, whose
last block folds the pairs deterministically: one launch) and its plain
version ``ref.graph_cut_select_ref``.
``graph_cut_select_batched`` is the reference's query-batched form: B
selection vectors and oks over one shared W, one launch that reads W once
for all of them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref, ring
from repro_torch.kernels import graph_cut_gain as _gc
from repro_torch.kernels import info_gain as _ig
from repro_torch.kernels.facility_gain import operands

launches = 0           # launches of csrc/facility.cu's facility select
coverage_launches = 0  # launches of csrc/facility.cu's coverage select
info_launches = 0      # launches of csrc/info_gain.cu's select
graph_cut_launches = 0  # launches of csrc/graph_cut.cu's select


def _top1_scratch(o):
  """(part, tile_best, tile_idx, best, idx) of a facility-family select:
  per-band top-1s with one eval chunk (a band is ``o.plan.band`` candidate
  rows), the chunk partials otherwise."""
  dev = o.ev.t.device
  if o.plan.chunks == 1:
    part = None
    tile_best = torch.empty((o.n_part, o.plan.bands), dtype=torch.float32,
                            device=dev)
    tile_idx = torch.empty((o.n_part, o.plan.bands), dtype=torch.int32,
                           device=dev)
  else:
    part = torch.empty((o.plan.chunks, o.n_part, o.nc), dtype=torch.float32,
                       device=dev)
    tile_best = tile_idx = None
  best = torch.empty((o.n_part,), dtype=torch.float32, device=dev)
  idx = torch.empty((o.n_part,), dtype=torch.int32, device=dev)
  return part, tile_best, tile_idx, best, idx


def _top1_result(o, best, idx):
  idx = idx.to(torch.int64)
  if o.batch is None:
    return best[0], idx[0]
  return best, idx


def facility_select(eval_feats: torch.Tensor, cand_feats: torch.Tensor,
                    cov: torch.Tensor, eval_mask: torch.Tensor,
                    cand_ok: torch.Tensor, *, kernel: str = "linear",
                    h: float = 0.75):
  """Fused top-1 facility gain -> (best float32, int64 index), each () or
  (P,) when an operand carries a partition axis.

  Tensors on the CPU take the plain version; CUDA tensors launch the
  kernel or raise.
  """
  if eval_feats.is_meta or cand_feats.is_meta:  # the dry run
    from repro_torch.kernels import meta
    best, idx = meta.gain_pass(cand_feats, eval_feats, kernel == "rbf", True)
    return best, idx
  if not (eval_feats.is_cuda or cand_feats.is_cuda):
    return ref.facility_select_ref(eval_feats, cand_feats, cov, eval_mask,
                                   cand_ok, kernel=kernel, h=h)
  global launches
  build.check_kernel("facility_select", kernel)
  build.check_width("facility_select", kernel, h)
  o = operands("facility_select", eval_feats, cand_feats, cov, eval_mask,
               cand_ok)
  dev = eval_feats.device
  part, tile_best, tile_idx, best, idx = _top1_scratch(o)
  with torch.cuda.device(dev):
    fn = build.entry("sm90_facility_select")
    err = fn(*o.head(), o.ok.data_ptr(), build.ptr(part),
             build.ptr(tile_best), build.ptr(tile_idx), best.data_ptr(),
             idx.data_ptr(), *o.dims(), build.batch_stride(o.ok, 1),
             o.plan.chunks, int(eval_feats.dtype == torch.bfloat16),
             int(kernel == "rbf"), float(h * h), int(o.ring.streamed),
             build.stream_of(eval_feats))
  build.check(err, "sm90_facility_select")
  launches += 1
  ring.mode_launches[("facility_select", o.ring.mode)] += 1
  return _top1_result(o, best, idx)


def coverage_select(eval_feats: torch.Tensor, cand_feats: torch.Tensor,
                    cover: torch.Tensor, cap: torch.Tensor,
                    eval_mask: torch.Tensor, cand_ok: torch.Tensor, *,
                    kernel: str = "linear", h: float = 0.75):
  """Fused top-1 saturated-coverage gain -> (best float32, int64 index),
  each () or (P,) when an operand carries a partition (or query) axis.

  Tensors on the CPU take the plain version; CUDA tensors launch the
  kernel or raise.
  """
  if not (eval_feats.is_cuda or cand_feats.is_cuda):
    return ref.coverage_select_ref(eval_feats, cand_feats, cover, cap,
                                   eval_mask, cand_ok, kernel=kernel, h=h)
  global coverage_launches
  build.check_kernel("coverage_select", kernel)
  build.check_width("coverage_select", kernel, h)
  o = operands("coverage_select", eval_feats, cand_feats, cover, eval_mask,
               cand_ok, cap=cap)
  part, tile_best, tile_idx, best, idx = _top1_scratch(o)
  with torch.cuda.device(eval_feats.device):
    fn = build.entry("sm90_coverage_select")
    err = fn(*o.head(), o.ok.data_ptr(), build.ptr(part),
             build.ptr(tile_best), build.ptr(tile_idx), best.data_ptr(),
             idx.data_ptr(), *o.dims(), build.batch_stride(o.ok, 1),
             o.plan.chunks, int(eval_feats.dtype == torch.bfloat16),
             int(kernel == "rbf"), float(h * h), int(o.ring.streamed),
             build.stream_of(eval_feats))
  build.check(err, "sm90_coverage_select")
  coverage_launches += 1
  ring.mode_launches[("coverage_select", o.ring.mode)] += 1
  return _top1_result(o, best, idx)


def info_select(sel_feats: torch.Tensor, linv: torch.Tensor,
                cand_feats: torch.Tensor, cand_ok: torch.Tensor, *,
                kernel: str = "rbf", h: float = 0.75, ridge: float = 1.0,
                live: torch.Tensor | None = None):
  """Fused top-1 conditional variance -> (best cond float32, int64 index),
  each () or (P,) when an operand carries a partition axis.  ``live`` is
  the selection-count contract of ``info_gain.info_gain_cond``.

  Tensors on the CPU take the plain version; CUDA tensors launch the
  kernel or raise.
  """
  if not (sel_feats.is_cuda or cand_feats.is_cuda):
    return ref.info_select_ref(sel_feats, linv, cand_feats, cand_ok,
                               kernel=kernel, h=h, ridge=ridge, live=live)
  global info_launches
  build.check_kernel("info_select", kernel)
  build.check_width("info_select", kernel, h)
  o = _ig.operands("info_select", sel_feats, linv, cand_feats, cand_ok,
                   live=live)
  dev = o.sel.device
  tile_best = torch.empty((o.n_part, o.tiles), dtype=torch.float32,
                          device=dev)
  tile_idx = torch.empty((o.n_part, o.tiles), dtype=torch.int32, device=dev)
  best = torch.empty((o.n_part,), dtype=torch.float32, device=dev)
  idx = torch.empty((o.n_part,), dtype=torch.int32, device=dev)
  with torch.cuda.device(dev):
    fn = build.entry("sm90_info_select")
    err = fn(o.sel.data_ptr(), o.linv.data_ptr(), o.cd.data_ptr(),
             o.ok.data_ptr(), build.ptr(o.live), build.ptr(o.scratch),
             tile_best.data_ptr(),
             tile_idx.data_ptr(), best.data_ptr(), idx.data_ptr(), o.n_part,
             o.k, o.nc, o.d, *_ig.strides(o), build.batch_stride(o.ok, 1),
             o.live_bs, int(o.sel.dtype == torch.bfloat16),
             int(kernel == "rbf"), float(h * h), float(ridge),
             build.stream_of(o.sel))
  build.check(err, "sm90_info_select")
  info_launches += 1
  return _top1_result(o, best, idx)


def graph_cut_select(w: torch.Tensor, in_s: torch.Tensor,
                     node_ok: torch.Tensor,
                     ind: torch.Tensor | None = None):
  """Fused top-1 node cut gain -> (best float32, int64 node), each () or
  (P,) when ``in_s``, ``node_ok`` or ``ind`` carries a leading axis of P
  selection vectors over the shared W.

  Tensors on the CPU take the plain version; CUDA tensors launch the
  kernel (one launch: the gains pass and, in its last block, the fold of
  the per-block pairs) or raise.
  """
  if not w.is_cuda:
    return ref.graph_cut_select_ref(w, in_s, node_ok, ind)
  global graph_cut_launches
  o = _gc.operands("graph_cut_select", w, in_s, node_ok=node_ok, ind=ind)
  dev = w.device
  n_tiles = _gc.tiles(o)
  # (best, index) pairs of every stripe of W: float32 bits, then int32
  pairs = torch.empty((2 * o.n_part * n_tiles,), dtype=torch.int32,
                      device=dev)
  tile_idx = pairs.data_ptr() + 4 * o.n_part * n_tiles
  best = torch.empty((o.n_part,), dtype=torch.float32, device=dev)
  idx = torch.empty((o.n_part,), dtype=torch.int64, device=dev)
  ind_args = (None, 0, 0, 0) if o.ind is None else o.ind.args()
  scratch = _gc.cbuf(o)
  with torch.cuda.device(dev):
    fn = build.entry("sm90_graph_cut_select")
    err = fn(w.data_ptr(), *o.x.args(), *ind_args, *o.ok.args()[:3],
             build.ptr(scratch), pairs.data_ptr(), tile_idx, _tickets(dev),
             best.data_ptr(), idx.data_ptr(), o.n, o.n_part,
             int(w.dtype == torch.bfloat16), o.vec, o.pb, build.stream_of(w))
  build.check(err, "sm90_graph_cut_select")
  graph_cut_launches += 1
  if o.batch is None:
    return best[0], idx[0]
  return best, idx


_TICKETS: dict = {}


def _tickets(dev) -> int:
  """The graph-cut select's ticket counters on ``dev`` (zero between
  launches: the kernel's folding block resets its own), allocated and
  zeroed at the first call."""
  if dev not in _TICKETS:
    _TICKETS[dev] = torch.zeros((build.MAX_GRID,), dtype=torch.int32,
                                device=dev)
  return _TICKETS[dev].data_ptr()


def graph_cut_select_batched(w: torch.Tensor, in_s: torch.Tensor,
                             node_ok: torch.Tensor):
  """The reference's query-batched select: ``in_s`` and ``node_ok`` (B, n)
  per query, W shared -> ((B,) best, (B,) node), one launch."""
  if in_s.dim() != 2 or node_ok.dim() != 2:
    raise ValueError("graph_cut_select_batched: in_s and node_ok must be "
                     f"(B, n), got {tuple(in_s.shape)} and "
                     f"{tuple(node_ok.shape)}")
  return graph_cut_select(w, in_s, node_ok)
