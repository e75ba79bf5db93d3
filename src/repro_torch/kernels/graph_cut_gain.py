"""Graph-cut node gains: the port of the TPU kernel
``src/repro/kernels/graph_cut_gain.py`` ``graph_cut_gain_pallas``.

For the cut f(S) = sum_{i in S, j not in S} w_ij, the marginal gain of node
v is deg_v - 2 (W x)_v = (W (1 - 2x))_v: one GEMV over W per selection
vector.  Each call takes P selection vectors (a leading axis on ``in_s``)
over one shared W, and reads W once for all of them.  Under local
evaluation ``ind`` is each partition's node indicator and the column vector
is ind * (1 - 2x): on the partition's nodes that is the gain in the
subgraph it induces, with no masked copy of W.

The CUDA kernel is ``csrc/graph_cut.cu`` (see the header there for its
bound and design); its plain version is ``ref.graph_cut_gain_ref``.  The
kernel reads x, the indicator and (for the select) the feasibility mask
where they lie, in their own dtype and with their own stride between
vectors, and forms the column vectors itself: ``operands`` only checks
them, so a call is one launch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

launches = 0  # launches of csrc/graph_cut.cu's gains through this wrapper

CHUNK = 512  # columns of c a staged chunk (csrc/graph_cut.cu GC_CK)
VEC_DTYPES = (torch.float32, torch.bool, torch.uint8)
_TILES: dict[tuple[int, int], int] = {}  # (n, pb) -> the select's tiles


class GCVec(NamedTuple):
  """A ((P,) n) vector operand as the kernel reads it."""
  t: torch.Tensor
  ps: int     # elements between the vectors of p (0: one shared by all)
  u8: int     # 1: one byte an element (bool / uint8), 0: float32
  wide: int   # 1: address, ps and n allow 4-element loads

  def args(self) -> tuple:
    return self.t.data_ptr(), self.ps, self.u8, self.wide


class GCOperands(NamedTuple):
  """Checked operands of the graph-cut kernels."""
  x: GCVec
  ind: GCVec | None
  ok: GCVec | None
  batch: int | None      # None: unbatched (one selection vector)
  n_part: int
  n: int
  vec: int               # W elements per load
  pb: int                # vectors per pass


def _vec(w: torch.Tensor, n: int) -> int:
  """The widest load the kernel may use on W's rows: 16 bytes when n and
  W's address are multiples of it, 8 for bf16 at n % 4 == 0, else one
  element (every load aligned)."""
  for v in ((4,) if w.dtype == torch.float32 else (8, 4)):
    if n % v == 0 and w.data_ptr() % (v * w.element_size()) == 0:
      return v
  return 1


def _operand(name: str, what: str, t: torch.Tensor, n: int,
             device) -> GCVec:
  if t.device != device:
    raise ValueError(f"{name}: {what} on {t.device}, W on {device}")
  if t.dtype not in VEC_DTYPES:
    raise TypeError(f"{name}: {what} must be float32, bool or uint8, got "
                    f"{t.dtype}")
  if t.dim() not in (1, 2):
    raise ValueError(f"{name}: {what} of shape {tuple(t.shape)}")
  if t.shape[-1] != n:
    raise ValueError(f"{name}: {what} of length {t.shape[-1]}, expected {n}")
  if t.stride(-1) != 1 and n > 1:
    raise ValueError(f"{name}: {what} must be contiguous along its n "
                     f"nodes, got strides {t.stride()}")
  ps = t.stride(0) if t.dim() == 2 else 0
  wide = int(n % 4 == 0 and ps % 4 == 0 and
             t.data_ptr() % (4 * t.element_size()) == 0)
  return GCVec(t, ps, int(t.dtype != torch.float32), wide)


def operands(name: str, w, in_s, node_ok=None, ind=None) -> GCOperands:
  """Check the graph-cut kernels' operands; builds nothing and launches
  nothing.

  w (n, n) float32 or bfloat16, contiguous; in_s (n,) or (P, n); ind (n,)
  or (P, n) or None; node_ok (n,) or (P, n).  Vectors are float32, bool or
  uint8 on W's device, contiguous along n, with any stride between their
  P rows (0: an expanded vector shared by all P).
  """
  if w.dtype not in (torch.float32, torch.bfloat16):
    raise TypeError(f"{name}: W must be float32 or bfloat16, got {w.dtype}")
  if w.dim() != 2 or w.shape[0] != w.shape[1] or not w.is_contiguous():
    raise ValueError(f"{name}: W must be a contiguous (n, n) matrix, got "
                     f"shape {tuple(w.shape)} strides {w.stride()}")
  n = w.shape[0]
  if n < 1:
    raise ValueError(f"{name}: empty graph")
  x = _operand(name, "in_s", in_s, n, w.device)
  vi = None if ind is None else _operand(name, "ind", ind, n, w.device)
  vo = None if node_ok is None else _operand(name, "node_ok", node_ok, n,
                                             w.device)
  batch = build.batch_of(name, *[(v.t, 1) for v in (x, vi, vo)
                                 if v is not None])
  n_part = 1 if batch is None else batch
  pb = 1 if n_part == 1 else 4 if n_part <= 4 else 16
  if -(-n_part // pb) > build.MAX_GRID:
    raise ValueError(f"{name}: {n_part} selection vectors exceed the grid")
  return GCOperands(x, vi, vo, batch, n_part, n, _vec(w, n), pb)


def columns(o: GCOperands) -> torch.Tensor:
  """The (n_part, n) float32 column vectors c = ind * (1 - 2x) as the
  kernel forms them from the operands: vector p of each operand starts
  p * ps elements past its first (the plain reading of the contract)."""
  def rows(v: GCVec) -> torch.Tensor:
    return v.t.as_strided((o.n_part, o.n), (v.ps, 1),
                          v.t.storage_offset()).to(torch.float32)
  c = 1.0 - 2.0 * rows(o.x)
  return c if o.ind is None else c * rows(o.ind)


def cbuf(o: GCOperands) -> torch.Tensor | None:
  """The kernel's float32 scratch for the column vectors of a pass of
  several vectors (uninitialised: the kernel writes all of it), or None."""
  if o.pb == 1:
    return None
  rows = -(-o.n_part // o.pb) * o.pb
  return torch.empty((rows * (-(-o.n // CHUNK) * CHUNK),),
                     dtype=torch.float32, device=o.x.t.device)


def tiles(o: GCOperands) -> int:
  """Per-block (best, index) pairs per vector of the select kernel (the
  kernel's row stripes; csrc/graph_cut.cu decides them)."""
  key = (o.n, o.pb)
  if key not in _TILES:
    _TILES[key] = build.entry("sm90_graph_cut_tiles")(o.n, o.pb)
  return _TILES[key]


def graph_cut_gain(w: torch.Tensor, in_s: torch.Tensor,
                   ind: torch.Tensor | None = None) -> torch.Tensor:
  """Node cut gains float32, (n,) or (P, n) when ``in_s`` or ``ind``
  carries a leading axis of P selection vectors over the shared W.

  Tensors on the CPU take the plain version; CUDA tensors launch the
  kernel (one launch) or raise.
  """
  if not w.is_cuda:
    return ref.graph_cut_gain_ref(w, in_s, ind)
  global launches
  o = operands("graph_cut_gain", w, in_s, ind=ind)
  gains = torch.empty((o.n_part, o.n), dtype=torch.float32, device=w.device)
  ind_args = (None, 0, 0, 0) if o.ind is None else o.ind.args()
  scratch = cbuf(o)
  with torch.cuda.device(w.device):
    fn = build.entry("sm90_graph_cut_gain")
    err = fn(w.data_ptr(), *o.x.args(), *ind_args, build.ptr(scratch),
             gains.data_ptr(), o.n, o.n_part, int(w.dtype == torch.bfloat16),
             o.vec, o.pb, build.stream_of(w))
  build.check(err, "sm90_graph_cut_gain")
  launches += 1
  return gains if o.batch is not None else gains[0]
