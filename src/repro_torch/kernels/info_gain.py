"""Information-gain conditional variances: the port of the TPU kernel
``src/repro/kernels/info_gain.py`` ``info_gain_cond_pallas``.

For every candidate v (per partition when batched)

    cond[v] = k(v, v) + ridge - || linv @ k(S, v) ||^2,  clamped at 1e-12

where ``linv`` is inv(chol(K_SS + ridge I)) with the columns past the live
selection count zeroed.  The GP information gain maps cond to
0.5 log(cond / sigma^2), the DPP log-det to log(cond).

``live`` (the selection counts, (P,) or (), an integer tensor on the
kernel's device; read there, no host sync) states that contract: ``linv``
is lower-triangular and only its ``live x live`` corner is non-zero.  The
kernel and the plain version then both apply exactly that mask (``tril``,
rows and columns at or past ``live`` zeroed), so they compute one function
of ``(linv, live)``; on a masked factor it is the dense product, and the
kernel does only the c (c + 1) / 2 products a candidate that the live
triangle holds.  Without ``live`` any ``linv`` is taken as it is (the dense
contract).  The objectives pass their selection counts.

The CUDA kernel is ``csrc/info_gain.cu`` (the cross-kernel tile and its
product with ``linv`` stay on chip, ``linv``'s live panels resident a block
where they fit, a per-block device scratch for shapes past shared memory;
see the header there for its bound and design).  Its plain version is
``ref.info_gain_cond_ref``.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

launches = 0  # launches of csrc/info_gain.cu's cond through this wrapper


class IGOperands(NamedTuple):
  """Checked kernel operands of the info-gain kernels."""
  sel: torch.Tensor
  linv: torch.Tensor
  cd: torch.Tensor
  ok: torch.Tensor | None
  live: torch.Tensor | None  # int64 selection counts; None: dense
  live_bs: int               # 1 per partition, 0 shared
  scratch: torch.Tensor | None  # device scratch the launch needs, or None
  batch: int | None     # None: no operand is batched
  n_part: int
  k: int
  nc: int
  d: int
  tiles: int            # a select's per-partition tile_best stride


def live_operand(name: str, live, n_part: int, batched: bool, dev):
  """``live`` as contiguous int64 on ``dev`` with its partition stride:
  () for every partition, or (P,)."""
  if live is None:
    return None, 0
  live = torch.as_tensor(live, device=dev)
  if live.device != dev:
    raise ValueError(f"{name}: live on {live.device}, features on {dev}")
  if live.dtype.is_floating_point or live.dtype.is_complex or \
      live.dtype == torch.bool:
    raise TypeError(f"{name}: live must be an integer tensor, got "
                    f"{live.dtype}")
  if live.dim() == 0:
    return live.to(torch.int64).reshape(1), 0
  if live.dim() == 1 and batched and live.shape[0] == n_part:
    return live.to(torch.int64).contiguous(), 1
  raise ValueError(f"{name}: live of shape {tuple(live.shape)}, expected () "
                   f"or ({n_part},) with a partition axis")


def operands(name: str, sel_feats, linv, cand_feats, cand_ok=None,
             live=None) -> IGOperands:
  """Validate the info-gain kernels' operands and settle the batch layout.

  sel_feats (k, d) | (P, k, d); linv (k, k) | (P, k, k) float32;
  cand_feats (nc, d) | (P, nc, d); cand_ok (nc,) | (P, nc); live () | (P,).
  Unbatched operands are shared by every partition (batch stride 0).
  """
  build.check_feats(name, sel_feats, cand_feats)
  dev = sel_feats.device
  k, d = sel_feats.shape[-2:]
  nc, dc = cand_feats.shape[-2:]
  if dc != d:
    raise ValueError(f"{name}: feature widths differ ({d} vs {dc})")
  if k < 1 or nc < 1:
    raise ValueError(f"{name}: needs at least one selection row and one "
                     f"candidate, got k={k}, nc={nc}")
  if linv.device != dev or linv.dtype != torch.float32:
    raise TypeError(f"{name}: linv must be float32 on {dev}, got "
                    f"{linv.dtype} on {linv.device}")
  if linv.dim() not in (2, 3) or tuple(linv.shape[-2:]) != (k, k):
    raise ValueError(f"{name}: linv of shape {tuple(linv.shape)}, expected "
                     f"({k}, {k}) or (P, {k}, {k})")
  pairs = [(sel_feats, 2), (linv, 2), (cand_feats, 2)]
  if cand_ok is not None:
    if cand_ok.dim() not in (1, 2):
      raise ValueError(f"{name}: ok of shape {tuple(cand_ok.shape)}")
    pairs.append((cand_ok, 1))
  batch = build.batch_of(name, *pairs)
  n_part = 1 if batch is None else batch
  if not 1 <= n_part <= build.MAX_GRID:
    raise ValueError(f"{name}: {n_part} partitions, expected 1 to "
                     f"{build.MAX_GRID}")
  live, live_bs = live_operand(name, live, n_part, batch is not None, dev)
  # csrc/info_gain.cu sizes its tiles, shared memory and scratch; this side
  # only allocates what it reports
  tiles, smem, nscr = ctypes.c_int64(0), ctypes.c_int64(0), ctypes.c_int64(0)
  with torch.cuda.device(dev):
    err = build.entry("sm90_info_plan")(
        n_part, k, d, nc, int(live is None), ctypes.byref(tiles),
        ctypes.byref(smem), ctypes.byref(nscr))
  if err != 0:
    raise ValueError(f"{name}: k={k} beyond the kernel (k + 1024 floats of "
                     "shared memory)")
  scratch = (None if nscr.value == 0 else
             torch.empty(nscr.value, dtype=torch.float32, device=dev))
  ok = None if cand_ok is None else build.vec(name, cand_ok, nc, dev)
  return IGOperands(sel_feats, linv.contiguous(), cand_feats, ok, live,
                    live_bs, scratch, batch, n_part, k, nc, d, tiles.value)


def strides(o: IGOperands) -> tuple[int, int, int]:
  """Batch strides of sel, linv and the candidates (0 = shared)."""
  return (build.batch_stride(o.sel, 2), build.batch_stride(o.linv, 2),
          build.batch_stride(o.cd, 2))


def info_gain_cond(sel_feats: torch.Tensor, linv: torch.Tensor,
                   cand_feats: torch.Tensor, *, kernel: str = "rbf",
                   h: float = 0.75, ridge: float = 1.0,
                   live: torch.Tensor | None = None) -> torch.Tensor:
  """Conditional variances float32, (nc,) or (P, nc).

  Tensors on the CPU take the plain version; CUDA tensors launch the
  kernel or raise.
  """
  if not (sel_feats.is_cuda or cand_feats.is_cuda):
    return ref.info_gain_cond_ref(sel_feats, linv, cand_feats, kernel=kernel,
                                  h=h, ridge=ridge, live=live)
  global launches
  build.check_kernel("info_gain_cond", kernel)
  build.check_width("info_gain_cond", kernel, h)
  o = operands("info_gain_cond", sel_feats, linv, cand_feats, live=live)
  cond = torch.empty((o.n_part, o.nc), dtype=torch.float32,
                     device=o.sel.device)
  with torch.cuda.device(o.sel.device):
    fn = build.entry("sm90_info_gain_cond")
    err = fn(o.sel.data_ptr(), o.linv.data_ptr(), o.cd.data_ptr(),
             build.ptr(o.live), build.ptr(o.scratch), cond.data_ptr(),
             o.n_part, o.k, o.nc, o.d,
             *strides(o), o.live_bs, int(o.sel.dtype == torch.bfloat16),
             int(kernel == "rbf"), float(h * h), float(ridge),
             build.stream_of(o.sel))
  build.check(err, "sm90_info_gain_cond")
  launches += 1
  return cond if o.batch is not None else cond[0]
