"""Threshold-sieve admission scan of the selection service's standing
sieves: the sequential part of the reference's ``sieve_update``
(``src/repro/kernels/ops.py:365``), whose ``lax.scan`` walks an append
chunk's rows in order.  The reference has no Pallas kernel for it; on the
card a Python loop over the rows would be one launch chain a row (1024 a
chunk), so the scan is one CUDA kernel, ``csrc/sieve.cu``: one warp a
(shard, bucket), the bucket's slot state in shared memory, candidates
handed out by a ballot, no atomics (see the header there for its bound).

``sieve_scan`` takes the two similarity sweeps the caller made
(``ops.sieve_update`` makes them with the ``pairwise`` kernel) and returns
the updated (gid, gain, src, count); its plain version is
``ref.sieve_scan_ref``, which it equals bit for bit: max is exact and
nothing is summed.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref

launches = 0  # launches of csrc/sieve.cu through this wrapper

MAX_K = 4096  # slots a bucket: the kernel's shared-memory slot state


def sieve_scan(s_pre: torch.Tensor, s_intra: torch.Tensor,
               rsq: torch.Tensor | None, msq_pre: torch.Tensor | None,
               gains: torch.Tensor, rgids: torch.Tensor, active: torch.Tensor,
               tau: torch.Tensor, sieve_gid: torch.Tensor,
               sieve_gain: torch.Tensor, sieve_count: torch.Tensor):
  """The admission scan over S shards' T buckets of k slots.

  ``s_pre`` (S, ab, T*k) float32, ``s_intra`` (ab, ab) float32; ``rsq``
  (ab,) and ``msq_pre`` (S, T, k) the clamped squared norms (linear
  kernel; None for rbf); ``gains`` (ab,) float32, ``rgids`` (ab,) int64
  (-1: padding), ``active`` (S, ab) bool, ``tau`` (T,) float32; the state
  ``sieve_gid`` (S, T, k) int64, ``sieve_gain`` (S, T, k) float32,
  ``sieve_count`` (S, T) int64.  Returns new (gid, gain, src, count), src
  (S, T, k) int64 the chunk row each slot admitted this chunk, else -1; the
  inputs are not modified.  Tensors on the CPU take the plain version; CUDA
  tensors launch the kernel or raise.
  """
  if not s_pre.is_cuda:
    return ref.sieve_scan_ref(s_pre, s_intra, rsq, msq_pre, gains, rgids,
                              active, tau, sieve_gid, sieve_gain, sieve_count)
  global launches
  n_sh, t, k = sieve_gid.shape
  ab = gains.shape[0]
  dev = s_pre.device
  linear = rsq is not None
  if k > MAX_K:
    raise ValueError(f"sieve_scan: {k} slots a bucket, at most {MAX_K}")
  if (msq_pre is None) == linear:
    raise ValueError("sieve_scan: rsq and msq_pre go together (linear)")
  want = {"s_pre": (s_pre, (n_sh, ab, t * k), torch.float32),
          "s_intra": (s_intra, (ab, ab), torch.float32),
          "gains": (gains, (ab,), torch.float32),
          "rgids": (rgids, (ab,), torch.int64),
          "active": (active, (n_sh, ab), torch.bool),
          "tau": (tau, (t,), torch.float32),
          "sieve_gain": (sieve_gain, (n_sh, t, k), torch.float32),
          "sieve_count": (sieve_count, (n_sh, t), torch.int64)}
  if linear:
    want["rsq"] = (rsq, (ab,), torch.float32)
    want["msq_pre"] = (msq_pre, (n_sh, t, k), torch.float32)
  for name, (x, shape, dtype) in want.items():
    if x.device != dev or tuple(x.shape) != shape or x.dtype != dtype:
      raise ValueError(f"sieve_scan: {name} must be {shape} {dtype} on {dev},"
                       f" got {tuple(x.shape)} {x.dtype} on {x.device}")
  if sieve_gid.device != dev or sieve_gid.dtype != torch.int64:
    raise ValueError("sieve_scan: sieve_gid must be int64 on the device")
  gid = sieve_gid.contiguous().clone()
  gain = sieve_gain.contiguous().clone()
  cnt = sieve_count.contiguous().clone()
  src = torch.empty((n_sh, t, k), dtype=torch.int64, device=dev)
  if ab == 0 or n_sh == 0:
    return gid, gain, src.fill_(-1), cnt
  ops = [x.contiguous() for x in (s_pre, s_intra, gains, rgids, tau)]
  act = active.contiguous().view(torch.uint8)
  rq = None if rsq is None else rsq.contiguous()
  mq = None if msq_pre is None else msq_pre.contiguous()
  with torch.cuda.device(dev):
    fn = build.entry("sm90_sieve_scan")
    err = fn(ops[0].data_ptr(), ops[1].data_ptr(), build.ptr(rq),
             build.ptr(mq), ops[2].data_ptr(), ops[3].data_ptr(),
             act.data_ptr(), ops[4].data_ptr(), gid.data_ptr(),
             gain.data_ptr(), src.data_ptr(), cnt.data_ptr(), n_sh, ab, t, k,
             int(linear), build.stream_of(s_pre))
  build.check(err, "sm90_sieve_scan")
  launches += 1
  return gid, gain, src, cnt
