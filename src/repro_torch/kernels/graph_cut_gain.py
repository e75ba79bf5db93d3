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
wrapper builds the column vectors, zero-padded to the kernel's 512-column
chunks and to a whole group of vectors per pass.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

launches = 0  # launches of csrc/graph_cut.cu's gains through this wrapper

CHUNK = 512  # columns per staged chunk (csrc/graph_cut.cu GC_CK)


class GCOperands(NamedTuple):
  """Checked operands of the graph-cut kernels."""
  c: torch.Tensor        # (groups * pb, ldc) float32 column vectors
  ok: torch.Tensor | None
  batch: int | None      # None: unbatched (one selection vector)
  n_part: int
  n: int
  ldc: int
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


def operands(name: str, w, in_s, node_ok=None, ind=None) -> GCOperands:
  """Validate the graph-cut kernels' operands and build the column vectors.

  w (n, n) float32 or bfloat16, contiguous, on a CUDA device; in_s (n,) or
  (P, n); ind (n,) or (P, n) or None; node_ok (n,) or (P, n).
  """
  if w.device.type != "cuda":
    raise ValueError(f"{name}: W must be on a CUDA device, got {w.device}")
  if w.dtype not in (torch.float32, torch.bfloat16):
    raise TypeError(f"{name}: W must be float32 or bfloat16, got {w.dtype}")
  if w.dim() != 2 or w.shape[0] != w.shape[1] or not w.is_contiguous():
    raise ValueError(f"{name}: W must be a contiguous (n, n) matrix, got "
                     f"shape {tuple(w.shape)} strides {w.stride()}")
  n = w.shape[0]
  if n < 1:
    raise ValueError(f"{name}: empty graph")
  pairs = [(in_s, 1)]
  for t in (ind, node_ok):
    if t is not None:
      if t.dim() not in (1, 2):
        raise ValueError(f"{name}: vector of shape {tuple(t.shape)}")
      pairs.append((t, 1))
  if in_s.dim() not in (1, 2):
    raise ValueError(f"{name}: in_s of shape {tuple(in_s.shape)}")
  batch = build.batch_of(name, *pairs)
  n_part = 1 if batch is None else batch
  if n_part > build.MAX_GRID:
    raise ValueError(f"{name}: {n_part} selection vectors exceed the grid")
  cols = ref.graph_cut_cols(build.vec(name, in_s, n, w.device),
                            None if ind is None
                            else build.vec(name, ind, n, w.device))
  pb = 1 if n_part == 1 else 4 if n_part <= 4 else 16
  ldc = -(-n // CHUNK) * CHUNK
  c = torch.zeros((-(-n_part // pb) * pb, ldc), dtype=torch.float32,
                  device=w.device)
  c[:n_part, :n] = cols.reshape(-1, n)
  ok = None if node_ok is None else build.vec(name, node_ok, n, w.device)
  return GCOperands(c, ok, batch, n_part, n, ldc, _vec(w, n), pb)


def graph_cut_gain(w: torch.Tensor, in_s: torch.Tensor,
                   ind: torch.Tensor | None = None) -> torch.Tensor:
  """Node cut gains float32, (n,) or (P, n) when ``in_s`` or ``ind``
  carries a leading axis of P selection vectors over the shared W.

  Tensors on the CPU take the plain version; CUDA tensors launch the
  kernel or raise.
  """
  if not w.is_cuda:
    return ref.graph_cut_gain_ref(w, in_s, ind)
  global launches
  o = operands("graph_cut_gain", w, in_s, ind=ind)
  gains = torch.empty((o.n_part, o.n), dtype=torch.float32, device=w.device)
  with torch.cuda.device(w.device):
    fn = build.entry("sm90_graph_cut_gain")
    err = fn(w.data_ptr(), o.c.data_ptr(), gains.data_ptr(), o.n, o.n_part,
             o.ldc, int(w.dtype == torch.bfloat16), o.vec, o.pb,
             build.stream_of(w))
  build.check(err, "sm90_graph_cut_gain")
  launches += 1
  return gains if o.batch is not None else gains[0]


def tiles(o: GCOperands) -> int:
  """Per-block (best, index) pairs per vector of the select kernel (the
  kernel's row stripes; csrc/graph_cut.cu decides them)."""
  return build.entry("sm90_graph_cut_tiles")(o.n, o.pb)
